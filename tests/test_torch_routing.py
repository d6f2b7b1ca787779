"""The port's routing (``persia_tpu_torch/routing.py``, the worker's
epochs, the ``__routing__`` rider) against the JAX package's, on the CPU:
``tests/test_routing.py``'s fifteen cases, each run on both packages.

- Tables (``uniform``, ``derive``, ``slots_of_replica``, ``moves_to``,
  ``to_bytes`` / ``from_bytes``) are equal between the packages, array
  for array and byte for byte (tolerance 0).
- The stale-error parsing gives the same epochs.
- The worker's split under a uniform table sends the same signs to the
  same replicas as the legacy modulo, and as the JAX worker, request for
  request; a custom table routes every sign to its slot's owner.
- The atomic swap under concurrent lookups, the double-read window and a
  worker's refusal of a table it has too few clients for behave as the
  JAX worker's.
- The rider negotiates down against a server without it, and a port
  ``PsService`` acks it with its epoch, to a port and to a JAX client.
"""

import threading

import numpy as np
import pytest

from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.ps.store import EmbeddingHolder
from persia_tpu_torch.routing import (
    STALE_PREFIX,
    RoutingHolder,
    RoutingStaleError,
    RoutingTable,
    is_routing_stale,
)
from persia_tpu_torch.worker import middleware as mw
from persia_tpu_torch.worker.worker import EmbeddingWorker

DIM = 8


def _schema(dim=DIM, n_slots=2, pkg="port"):
    if pkg == "jax":
        from persia_tpu.config import EmbeddingSchema as JSchema
        from persia_tpu.config import uniform_slots as juniform

        return JSchema(slots_config=juniform(
            [f"slot_{i}" for i in range(n_slots)], dim=dim))
    return EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{i}" for i in range(n_slots)], dim=dim))


def _feature(name, signs, pkg="port"):
    if pkg == "jax":
        from persia_tpu.data.batch import IDTypeFeature as JFeature

        return JFeature(name, [np.asarray(signs, dtype=np.uint64)])
    return IDTypeFeature(name, [np.asarray(signs, dtype=np.uint64)])


def _holders(n, pkg="port"):
    if pkg == "jax":
        from persia_tpu.ps.store import EmbeddingHolder as JHolder

        cls = JHolder
    else:
        cls = EmbeddingHolder
    hs = []
    for _ in range(n):
        h = cls(capacity=100_000)
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                    admit_probability=1.0, weight_bound=100.0)
        h.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
        hs.append(h)
    return hs


def _tables(n, spr=None):
    from persia_tpu.routing import RoutingTable as JTable

    return RoutingTable.uniform(n, spr), JTable.uniform(n, spr)


def _same(t, j):
    assert t.to_bytes() == j.to_bytes()
    assert t.is_uniform_modulo == j.is_uniform_modulo
    np.testing.assert_array_equal(t.replica_of_slot, j.replica_of_slot)


# --- the routing function ---------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2, 3, 5, 8])
def test_uniform_table_is_bit_exact_modulo(replicas):
    t, j = _tables(replicas)
    _same(t, j)
    assert t.is_uniform_modulo
    signs = np.random.default_rng(0).integers(
        0, 1 << 63, size=4096, dtype=np.uint64)
    np.testing.assert_array_equal(t.replica_of(signs),
                                  sign_to_shard(signs, replicas))
    np.testing.assert_array_equal(t.replica_of(signs), j.replica_of(signs))


def test_non_uniform_detection_and_slots_of_replica():
    t, j = _tables(2, 4)  # 8 slots
    assert t.is_uniform_modulo
    custom = t.derive([0, 0, 0, 0, 0, 1, 1, 1], 2)
    jcustom = j.derive([0, 0, 0, 0, 0, 1, 1, 1], 2)
    _same(custom, jcustom)
    assert not custom.is_uniform_modulo
    np.testing.assert_array_equal(custom.slots_of_replica(0),
                                  [0, 1, 2, 3, 4])
    for r in (0, 1):
        np.testing.assert_array_equal(custom.slots_of_replica(r),
                                      jcustom.slots_of_replica(r))
    signs = np.arange(1000, dtype=np.uint64)
    slots = custom.slot_of(signs)
    np.testing.assert_array_equal(
        custom.replica_of(signs), custom.replica_of_slot[slots])
    np.testing.assert_array_equal(custom.replica_of(signs),
                                  jcustom.replica_of(signs))


def test_epoch_monotonicity_and_holder_swap():
    from persia_tpu.routing import RoutingHolder as JHolder

    t1, j1 = _tables(2, 4)
    for holder_cls, first, tab in ((RoutingHolder, t1, RoutingTable),
                                   (JHolder, j1, None)):
        h = holder_cls(first)
        t2 = first.derive(np.zeros(8, np.int32), 1)
        assert t2.epoch == first.epoch + 1
        assert h.apply(t2)
        assert h.table is t2
        assert h.prev is first
        assert not h.apply(t2)
        assert not h.apply(first)
        assert h.table is t2
        h.close_window()
        assert h.prev is None
    _same(t1.derive(np.zeros(8, np.int32), 1),
          j1.derive(np.zeros(8, np.int32), 1))


def test_derive_refuses_slot_space_change():
    t, j = _tables(2, 4)
    for table in (t, j):
        with pytest.raises(ValueError, match="slot space"):
            table.derive(np.zeros(16, np.int32), 2)


def test_moves_to_groups_by_donor_target():
    t, j = _tables(2, 2)  # 4 slots: 0101
    t2, j2 = t.derive([0, 1, 2, 2], 3), j.derive([0, 1, 2, 2], 3)
    moves = t.moves_to(t2)
    assert moves == j.moves_to(j2)
    assert {(m["donor"], m["target"]) for m in moves} == {(0, 2), (1, 2)}
    assert sorted(s for m in moves for s in m["slots"]) == [2, 3]


def test_serialization_round_trip_and_version_gate():
    from persia_tpu.routing import RoutingTable as JTable

    t, j = _tables(3, 5)
    t2 = t.derive(np.arange(15, dtype=np.int32) % 2, 2,
                  weights=np.linspace(0, 1, 15))
    j2 = j.derive(np.arange(15, dtype=np.int32) % 2, 2,
                  weights=np.linspace(0, 1, 15))
    for table, ref in ((t, j), (t2, j2)):
        raw = table.to_bytes()
        assert raw == ref.to_bytes()
        back = RoutingTable.from_bytes(raw)
        assert back == table
        assert back.to_bytes() == raw
        assert JTable.from_bytes(raw).to_bytes() == raw
    doc = t.to_doc()
    doc["v"] = 99
    with pytest.raises(ValueError, match="version"):
        RoutingTable.from_doc(doc)


def test_stale_error_parsing():
    from persia_tpu.routing import is_routing_stale as j_stale
    from persia_tpu_torch.rpc import RpcError

    cases = [RoutingStaleError(7),
             RpcError(f"ps0: handler failed: {STALE_PREFIX}12 "),
             RpcError("boring failure"), RuntimeError(STALE_PREFIX)]
    assert [is_routing_stale(e) for e in cases] == [7, 12, None, None]
    assert [j_stale(e) for e in cases[1:]] \
        == [is_routing_stale(e) for e in cases[1:]]


# --- middleware integration -------------------------------------------------


def test_shard_split_uniform_routing_identical_to_legacy():
    from persia_tpu.worker import middleware as jmw

    schema, jschema = _schema(n_slots=3), _schema(n_slots=3, pkg="jax")
    rng = np.random.default_rng(1)
    raw = [rng.integers(0, 1 << 40, 257, dtype=np.uint64) for _ in range(3)]
    feats = mw.preprocess_batch(
        [_feature(f"slot_{i}", r) for i, r in enumerate(raw)], schema)
    jfeats = jmw.preprocess_batch(
        [_feature(f"slot_{i}", r, "jax") for i, r in enumerate(raw)],
        jschema)
    legacy = mw.shard_split(feats, schema, 4)
    routed = mw.shard_split(feats, schema, 4,
                            routing=RoutingTable.uniform(4))
    jrouted = jmw.shard_split(jfeats, jschema, 4, routing=_tables(4)[1])
    assert len(legacy) == len(routed) == len(jrouted)
    for a, b, c in zip(legacy, routed, jrouted):
        assert (a.shard, a.dim) == (b.shard, b.dim) == (c.shard, c.dim)
        np.testing.assert_array_equal(a.signs, b.signs)
        np.testing.assert_array_equal(a.signs, c.signs)
        np.testing.assert_array_equal(a.distinct_idx, b.distinct_idx)
        np.testing.assert_array_equal(a.distinct_idx, c.distinct_idx)


def test_shard_split_honors_custom_table():
    from persia_tpu.worker import middleware as jmw

    schema, jschema = _schema(n_slots=1), _schema(n_slots=1, pkg="jax")
    signs = np.arange(2048, dtype=np.uint64)
    feats = mw.preprocess_batch([_feature("slot_0", signs)], schema)
    jfeats = jmw.preprocess_batch([_feature("slot_0", signs, "jax")],
                                  jschema)
    t, j = _tables(2, 4)
    groups = mw.shard_split(feats, schema, 2,
                            routing=t.derive(np.ones(8, np.int32), 2))
    assert [g.shard for g in groups] == [1]
    assert len(groups[0].signs) == feats[0].num_distinct
    # a mixed table splits as JAX's does
    mixed = [0, 1, 1, 0, 1, 0, 0, 1]
    mine = mw.shard_split(feats, schema, 2, routing=t.derive(mixed, 2))
    ref = jmw.shard_split(jfeats, jschema, 2, routing=j.derive(mixed, 2))
    assert [g.shard for g in mine] == [g.shard for g in ref]
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.signs, b.signs)


# --- worker integration -----------------------------------------------------


class _CountingHolder:
    def __init__(self):
        self.calls = 0
        self.signs = 0

    def lookup(self, signs, dim, training):
        self.calls += 1
        self.signs += len(signs)
        return np.zeros((len(signs), dim), np.float32)


def test_worker_uniform_served_request_counts_pinned():
    """A worker born with an explicit uniform table splits traffic as the
    legacy modulo worker does, request for request, in both packages (an
    extra RPC, such as an unarmed rider's probe, would break the count
    equality)."""
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    rng = np.random.default_rng(2)
    raw = [[rng.integers(0, 1 << 40, 511, dtype=np.uint64)
            for _ in range(2)] for _ in range(3)]
    counts = []
    for pkg, cls, tables in (("port", EmbeddingWorker,
                              (None, RoutingTable.uniform(3))),
                             ("jax", JWorker, (None, _tables(3)[1]))):
        for routing in tables:
            holders = [_CountingHolder() for _ in range(3)]
            w = cls(_schema(pkg=pkg), holders, routing=routing)
            for b in raw:
                w.lookup_direct([_feature(f"slot_{i}", r, pkg)
                                 for i, r in enumerate(b)])
            w.close()
            counts.append([(h.calls, h.signs) for h in holders])
    assert counts[0] == counts[1] == counts[2] == counts[3]


def test_worker_atomic_swap_under_concurrent_lookups():
    """Lookups from four threads while six successor tables land: every
    lookup completes against one coherent table."""
    schema = _schema()
    w = EmbeddingWorker(schema, _holders(3))
    t = w.routing
    stop = threading.Event()
    errors = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            feats = [_feature(f"slot_{i}",
                              rng.integers(0, 1 << 30, 64, dtype=np.uint64))
                     for i in range(2)]
            try:
                out = w.lookup_direct(feats, training=True)
                for i in range(2):
                    assert out[f"slot_{i}"].embeddings.shape[1] == DIM
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(4)]
    for th in threads:
        th.start()
    rng = np.random.default_rng(99)
    try:
        for _ in range(6):
            t = t.derive(rng.integers(0, 3, t.num_slots).astype(np.int32), 3)
            assert w.apply_routing(t)
            assert not w.apply_routing(t)  # a duplicate publish
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        w.close()
    assert not errors
    assert w.routing_epoch == t.epoch == 7


def test_double_read_window_serves_moved_rows_from_donor():
    """After a cutover with no migration, an eval read of a moved row
    falls back to its previous owner until the window closes, in both
    packages."""
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    sign = 12345
    row = np.arange(DIM, dtype=np.float32) + 1.0
    got = []
    for pkg, cls in (("port", EmbeddingWorker), ("jax", JWorker)):
        holders = _holders(2, pkg)
        w = cls(_schema(pkg=pkg), holders)
        t1 = w.routing
        slot = int(t1.slot_of(np.array([sign], np.uint64))[0])
        donor = int(t1.replica_of_slot[slot])
        holders[donor].set_entry(sign, DIM, np.concatenate([row, row]))
        assignment = t1.replica_of_slot.copy()
        assignment[slot] = 1 - donor
        assert w.apply_routing(t1.derive(assignment, 2))
        before = w.lookup_signs(np.array([sign], np.uint64), DIM)
        w.close_routing_window()
        after = w.lookup_signs(np.array([sign], np.uint64), DIM)
        w.close()
        got.append((before, after))
    for before, after in got:
        np.testing.assert_array_equal(before[0], row)
        np.testing.assert_array_equal(after[0], np.zeros(DIM))


def test_worker_refuses_undersized_client_list():
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    with pytest.raises(ValueError, match="replicas"):
        EmbeddingWorker(_schema(), _holders(2),
                        routing=RoutingTable.uniform(4))
    with pytest.raises(ValueError, match="replicas"):
        JWorker(_schema(pkg="jax"), _holders(2, "jax"),
                routing=_tables(4)[1])
    w = EmbeddingWorker(_schema(), _holders(2))
    with pytest.raises(ValueError, match="replicas"):
        w.apply_routing(w.routing.derive(w.routing.replica_of_slot, 4))
    w.close()


# --- the __routing__ envelope rider ----------------------------------------


def test_routing_probe_negotiates_down_against_legacy_server():
    """A rider-armed port client against a server that never registered
    ``__routing__`` (a port server, then a JAX one) falls back: the probe
    is refused, no rider, calls work."""
    from persia_tpu.rpc import RpcServer as JServer
    from persia_tpu_torch.rpc import RpcClient, RpcServer

    for cls in (RpcServer, JServer):
        srv = cls("127.0.0.1", 0)
        srv.register("echo", lambda p: p)
        srv.serve_background()
        try:
            c = RpcClient(srv.addr, enable_routing=True)
            assert c.call("echo", b"x") == b"x"
            assert c.routing_active() is False
            c.close()
        finally:
            srv.stop()


def test_routing_probe_acks_with_epoch_on_ps_service():
    """The port's ``PsService`` acks the rider with its epoch: a port and
    a JAX client see it, ``reshard_status`` reports it, and an unarmed
    client never probes."""
    from persia_tpu.service.ps_service import PsClient as JClient
    from persia_tpu_torch.service.ps_service import PsClient, PsService

    svc = PsService(_holders(1)[0], port=0)
    svc.server.serve_background()
    try:
        client = PsClient(svc.addr, routing_wire=True)
        client.set_routing_epoch(3)
        assert client.client.routing_active() is True
        st = client.reshard_status()
        assert st["routing_epoch"] == 3 and st["active"] is False
        jclient = JClient(svc.addr, routing_wire=True)
        assert jclient.client.routing_active() is True
        assert jclient.reshard_status() == st
        # the epoch rides lookups and updates once the rider is up
        assert client._lookup_meta(DIM, True)["re"] == 3
        legacy = PsClient(svc.addr, routing_wire=False)
        assert legacy.client.routing_active() is False
        assert "re" not in legacy._lookup_meta(DIM, True)
        legacy.lookup(np.array([1, 2], np.uint64), DIM, False)
    finally:
        svc.stop()
