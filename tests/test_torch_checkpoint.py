"""The port's checkpoints against the JAX package's, on the CPU:
``dump_sharded`` writes the same PSD files and marker, dumps load across
the two packages at the same and at a changed shard count, a non-uniform
routing table in the marker drives the ownership filter, and the
context's ``dump_checkpoint`` / ``load_checkpoint`` round-trip the dense
and the sparse state.

The dense file is the stated difference: the port writes ``dense.pt``
(``torch.save`` of the model's and the optimizer's state dicts) where the
JAX package writes flax msgpack as ``dense.msgpack``, and a directory
that holds only the latter is refused.
"""

import copy
import io
import json
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from persia_tpu import checkpoint as jckpt
from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
from persia_tpu.ps.store import EmbeddingHolder as JLegacy
from persia_tpu.routing import RoutingTable as JRouting
from persia_tpu_torch import checkpoint as tckpt
from persia_tpu_torch import config as tcfg
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder as TArena
from persia_tpu_torch.ps.native import NativeEmbeddingHolder as TNative
from persia_tpu_torch.ps.store import EmbeddingHolder as TLegacy
from persia_tpu_torch.routing import RoutingTable as TRouting
from test_torch_pipeline import _batches, _port_ctx

DIM = 4
SGD = {"type": "sgd", "lr": 0.1, "wd": 0.0}


def _holders(cls, n, **kw):
    out = []
    for _ in range(n):
        h = cls(10_000, 2, **kw)
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
        h.register_optimizer(SGD)
        out.append(h)
    return out


def _fill(holders, num_signs=200, dim=DIM):
    """Train-lookup rows onto the replica the worker routes each sign to,
    then one gradient step on every row."""
    signs = np.arange(1, num_signs + 1, dtype=np.uint64)
    shards = sign_to_shard(signs, len(holders))
    for i, h in enumerate(holders):
        mine = signs[shards == i]
        h.lookup(mine, dim, training=True)
        h.update_gradients(mine, np.full((len(mine), dim), 0.25,
                                         np.float32), dim)
    return signs


def _rows(holders):
    """sign -> (replica, f32 row) over the holders' dumps."""
    out = {}
    for r, h in enumerate(holders):
        for sign in range(1, 2000):
            e = h.get_entry(sign)
            if e is not None:
                assert sign not in out, f"sign {sign} on two replicas"
                out[sign] = (r, np.array(e[1]))
    return out


@pytest.mark.parametrize("jcls,tcls,kw", [
    (JLegacy, TLegacy, {}),
    (JArena, TArena, {}),
    (JArena, TArena, {"row_dtype": "bf16"}),
    (JArena, TNative, {"row_dtype": "fp16"}),
], ids=["per-entry", "arena", "arena-bf16", "native-fp16"])
def test_dump_sharded_files_equal_jax(jcls, tcls, kw, tmp_path):
    jh, th = _holders(jcls, 2, **kw), _holders(tcls, 2, **kw)
    _fill(jh)
    _fill(th)
    jckpt.dump_sharded(jh, str(tmp_path / "jax"))
    tckpt.dump_sharded(th, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "embedding_dump_done", "replica_0.psd", "replica_1.psd"]
    for name in names[1:]:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    jm = jckpt.read_done_marker(str(tmp_path / "jax"))
    tm = tckpt.read_done_marker(str(tmp_path / "port"))
    assert set(tm) == set(jm) == {"num_shards", "datetime"}
    assert tm["num_shards"] == 2


@pytest.mark.parametrize("n_load", [2, 3])
def test_dumps_load_across_the_packages(n_load, tmp_path):
    """A JAX-written dump loads into the port and a port-written one into
    the JAX package, at the same shard count and resharded 2 -> 3; every
    row lands on the replica the worker routes it to."""
    jh, th = _holders(JLegacy, 2), _holders(TArena, 2)
    signs = _fill(jh, 300)
    _fill(th, 300)
    jckpt.dump_sharded(jh, str(tmp_path / "jax"))
    tckpt.dump_sharded(th, str(tmp_path / "port"))
    into_port = _holders(TLegacy, n_load)
    tckpt.load_sharded(into_port, str(tmp_path / "jax"))
    into_jax = _holders(JLegacy, n_load)
    jckpt.load_sharded(into_jax, str(tmp_path / "port"))
    want = {s: row for s, (_, row) in _rows(jh).items()}
    for loaded in (_rows(into_port), _rows(into_jax)):
        assert set(loaded) == set(int(s) for s in signs)
        owner = dict(zip(signs.tolist(),
                         sign_to_shard(signs, n_load).tolist()))
        for s, (r, row) in loaded.items():
            assert r == owner[s]
            np.testing.assert_array_equal(row, want[s])


def test_routing_marker_drives_the_ownership_filter(tmp_path):
    """A non-uniform table made by the JAX package's ``derive`` is recorded
    in the marker; loading onto another fleet keeps from each file only
    the rows its replica owned under it, so a donor's stale copy never
    overwrites the owner's row."""
    juni = JRouting.uniform(2)
    custom = juni.derive((juni.replica_of_slot + 1) % 2, 2)
    tcustom = TRouting.from_doc(custom.to_doc())
    assert tcustom == TRouting.from_doc(tcustom.to_doc())
    assert not tcustom.is_uniform_modulo
    holders = _holders(TLegacy, 2)
    signs = np.arange(1, 201, dtype=np.uint64)
    owner = tcustom.replica_of(signs)
    np.testing.assert_array_equal(owner, custom.replica_of(signs))
    for s, r in zip(signs.tolist(), owner.tolist()):
        holders[r].set_entry(s, DIM, np.full(DIM, 1.0, np.float32))
        # the donor keeps a stale copy
        holders[1 - r].set_entry(s, DIM, np.full(DIM, -7.0, np.float32))
    tckpt.dump_sharded(holders, str(tmp_path / "d"), routing=tcustom)
    marker = json.loads((tmp_path / "d" / "embedding_dump_done").read_text())
    assert marker["routing"] == custom.to_doc()
    fresh = _holders(TLegacy, 3)
    tckpt.load_sharded(fresh, str(tmp_path / "d"))
    rows = _rows(fresh)
    assert set(rows) == set(signs.tolist())
    uni3 = sign_to_shard(signs, 3)
    for s, r in zip(signs.tolist(), uni3.tolist()):
        assert rows[s][0] == r
        np.testing.assert_array_equal(rows[s][1], np.ones(DIM, np.float32))
    # a live table equal to the dump's streams the files straight in
    same = _holders(TLegacy, 2)
    tckpt.load_sharded(same, str(tmp_path / "d"), routing=tcustom)
    assert [len(h) for h in same] == [len(h) for h in holders]


def _v1_file(path, records):
    with open(path, "wb") as f:
        f.write(b"PSD1" + struct.pack("<IQ", 1, len(records)))
        for sign, dim, vec in records:
            f.write(struct.pack("<QII", sign, dim, len(vec)))
            f.write(np.asarray(vec, np.float32).tobytes())


def test_iter_psd_entries_reads_v1_and_v2(tmp_path):
    recs = [(7, 2, [1.0, 2.0, 3.0]), (9, 3, [0.5, -1.0, 2.0])]
    _v1_file(tmp_path / "v1.psd", recs)
    got = list(tckpt.iter_psd_entries(str(tmp_path / "v1.psd")))
    assert [(s, d) for s, d, _ in got] == [(7, 2), (9, 3)]
    np.testing.assert_array_equal(got[0][2], recs[0][2])
    assert list(map(lambda r: (r[0], r[1], r[2].tolist()), got)) == \
        list(map(lambda r: (r[0], r[1], r[2].tolist()),
                 jckpt.iter_psd_entries(str(tmp_path / "v1.psd"))))
    (h,) = _holders(TArena, 1, row_dtype="bf16")
    h.lookup(np.arange(1, 11, dtype=np.uint64), DIM, training=True)
    h.dump_file(str(tmp_path / "v2.psd"))
    v2 = list(tckpt.iter_psd_entries(str(tmp_path / "v2.psd")))
    jv2 = list(jckpt.iter_psd_entries(str(tmp_path / "v2.psd")))
    assert len(v2) == len(jv2) == 10
    for (s, d, v), (js, jd, jv) in zip(v2, jv2):
        assert (s, d) == (js, jd)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(v, h.get_entry(s)[1])


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_ctx_checkpoint_round_trips_dense_and_sparse(tmp_path):
    ctx = _port_ctx()
    ckpt_dir = str(tmp_path / "ckpt")
    with ctx:
        batches = list(_batches(6))
        for b in batches[:3]:
            ctx.train_step(b)
        ctx.dump_checkpoint(ckpt_dir)
        params = _params(ctx.model)
        # the state dict holds the live tensors
        opt_state = copy.deepcopy(ctx.dense_optimizer.state_dict())
        ps = _rows(ctx.worker.ps_clients)
        for b in batches[3:]:
            ctx.train_step(b)
        assert not torch.equal(ctx.model.state_dict()["Dense_0.weight"],
                               params["Dense_0.weight"])
        ctx.load_checkpoint(ckpt_dir)
    assert sorted(os.listdir(ckpt_dir)) == [
        "dense.pt", "embedding_dump_done", "replica_0.psd", "replica_1.psd"]
    for k, v in ctx.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    restored = ctx.dense_optimizer.state_dict()
    assert restored["param_groups"] == opt_state["param_groups"]
    for i, st in opt_state["state"].items():
        for k, v in st.items():
            assert torch.equal(restored["state"][i][k], v)
    after = _rows(ctx.worker.ps_clients)
    assert set(after) == set(ps)
    for s, (r, row) in ps.items():
        assert after[s][0] == r
        np.testing.assert_array_equal(after[s][1], row)
    # the sparse side alone leaves the dense state as it is
    other = _port_ctx(seed=11)
    before = _params(other.model)
    with other:
        other.load_checkpoint(ckpt_dir, with_dense=False)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k])
    assert set(_rows(other.worker.ps_clients)) == set(ps)


def test_jax_dense_file_is_refused(tmp_path):
    ctx = _port_ctx()
    with ctx:
        ctx.train_step(next(iter(_batches(1))))
        ctx.dump_checkpoint(str(tmp_path / "c"))
    os.rename(tmp_path / "c" / "dense.pt", tmp_path / "c" / "dense.msgpack")
    with pytest.raises(ValueError, match="dense.msgpack"):
        ctx.load_checkpoint(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="dense.msgpack"):
        tckpt.dense_file(str(tmp_path / "c"))
    ctx.load_checkpoint(str(tmp_path / "c"), with_dense=False)
    # a directory with neither file has no dense state
    os.remove(tmp_path / "c" / "dense.msgpack")
    assert tckpt.dense_file(str(tmp_path / "c")) is None


def test_dense_bytes_load_with_weights_only(tmp_path):
    """``dense.pt`` holds tensors and plain containers only, so the
    restricted unpickler reads it; a pickled object is refused."""
    ctx = _port_ctx()
    data = tckpt.dense_state_bytes((ctx.model, ctx.dense_optimizer))
    doc = torch.load(io.BytesIO(data), weights_only=True)
    assert set(doc) == {"model", "optimizer"}
    evil = io.BytesIO()
    torch.save({"model": {}, "optimizer": None, "x": tcfg.CommonConfig()},
               evil)
    with pytest.raises(pickle.UnpicklingError):
        tckpt.apply_dense_bytes((ctx.model, None), evil.getvalue())
