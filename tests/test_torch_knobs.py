"""The port's ``PERSIA_*`` knobs against the JAX package's, on the CPU.

Each knob the port once read outside its registry, or not at all
(``PERSIA_WORKLOAD_SEED`` / ``_ALPHA``, ``PERSIA_SKIP_CHECK_DATA``,
``PERSIA_PS_BACKEND``, ``PERSIA_ARENA_SLAB_ROWS`` / ``_INDEX_SLOTS``,
``PERSIA_WORKER_STREAMING``), and the three the online tier reads
(``PERSIA_ONLINE_*``), is set unset, to ``""``, to ``" 1"`` and to a
value of its own, and the site that reads it must behave as the JAX
package's site does under the same environment: the same scenario bytes,
the same validation, the same holder backend, arena sizes, worker plane
and subscriber settings. The live-routing knobs
(``PERSIA_ROUTING_SLOTS_PER_REPLICA``, ``PERSIA_ROUTING_WIRE`` and the
``PERSIA_RESHARD_*`` ones) the same way, at the sites that read them.
Tolerance: equality.
"""

import numpy as np
import pytest

from persia_tpu_torch import knobs as tknobs

UNSET = object()
OWN = {
    "PERSIA_WORKLOAD_SEED": "3",
    "PERSIA_WORKLOAD_ALPHA": "1.3",
    "PERSIA_SKIP_CHECK_DATA": "TRUE",
    "PERSIA_PS_BACKEND": "python-legacy",
    "PERSIA_ARENA_SLAB_ROWS": "4096",
    "PERSIA_ARENA_INDEX_SLOTS": "64",
    "PERSIA_WORKER_STREAMING": "0",
    "PERSIA_ONLINE_APPLY_BATCH_ROWS": "17",
    "PERSIA_ONLINE_APPLY_ROWS_PER_SEC": "1000",
    "PERSIA_ONLINE_SCAN_SEC": "0.25",
}


def _values(name):
    return [pytest.param(
        name, v, id=f"{name}-{'unset' if v is UNSET else repr(v)}")
        for v in (UNSET, "", " 1", OWN[name])]


def _set(monkeypatch, name, value):
    if value is UNSET:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _both(fn_port, fn_jax):
    """Each side's result, or the type of the error it raised."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — the error is the result
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("name", sorted(OWN))
def test_knob_is_registered_as_in_jax(name):
    from persia_tpu import knobs as jknobs

    mine, ref = tknobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)


@pytest.mark.parametrize("name,value", _values("PERSIA_WORKLOAD_SEED")
                         + _values("PERSIA_WORKLOAD_ALPHA"))
def test_workload_knobs(name, value, monkeypatch):
    from persia_tpu.workloads import registry as jreg

    from persia_tpu_torch.workloads import registry as treg

    _set(monkeypatch, name, value)

    def first(reg):
        sc = reg.get_scenario("dlrm", smoke=True)
        return next(iter(sc.batches(64, 32))).to_bytes()

    mine, ref = _both(lambda: first(treg), lambda: first(jreg))
    assert isinstance(mine, bytes) and mine == ref


@pytest.mark.parametrize("name,value", _values("PERSIA_SKIP_CHECK_DATA")
                         + [pytest.param("PERSIA_SKIP_CHECK_DATA", "1",
                                         id="PERSIA_SKIP_CHECK_DATA-'1'")])
def test_skip_check_data(name, value, monkeypatch):
    from persia_tpu.data import batch as jbatch
    from persia_tpu.env import skip_check_data as jskip

    from persia_tpu_torch.data import batch as tbatch

    _set(monkeypatch, name, value)
    assert tbatch.skip_check_data() == jskip()
    # a 0-d label array: validated, it raises
    bad = np.array(1.0, np.float32)
    mine, ref = _both(lambda: tbatch.Label(bad).data.shape,
                      lambda: jbatch.Label(bad).data.shape)
    assert mine == ref


@pytest.mark.parametrize("name,value", _values("PERSIA_PS_BACKEND")
                         + [pytest.param("PERSIA_PS_BACKEND", "arena",
                                         id="PERSIA_PS_BACKEND-'arena'")])
def test_ps_backend(name, value, monkeypatch):
    """The knob picks ``make_holder``'s backend when none is passed, as
    in JAX; unset and empty mean ``auto``, which each package resolves to
    its own native store."""
    from persia_tpu.ps import native as jnative

    from persia_tpu_torch.ps import native as tnative

    _set(monkeypatch, name, value)
    mine, ref = _both(lambda: type(tnative.make_holder(100, 2)).__name__,
                      lambda: type(jnative.make_holder(100, 2)).__name__)
    if value in (UNSET, ""):
        auto = _both(
            lambda: type(tnative.make_holder(100, 2, backend="auto")
                         ).__name__,
            lambda: type(jnative.make_holder(100, 2, backend="auto")
                         ).__name__)
        assert [mine, ref] == auto
    else:
        assert mine == ref


@pytest.mark.parametrize("name,value", _values("PERSIA_ARENA_SLAB_ROWS")
                         + _values("PERSIA_ARENA_INDEX_SLOTS"))
def test_arena_sizes(name, value, monkeypatch):
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena

    from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder as TArena

    _set(monkeypatch, name, value)

    def sizes(cls):
        h = cls(1000, 2)
        sh = h._shards[0]
        return sh.slab_rows, sh._h_size

    mine, ref = _both(lambda: sizes(TArena), lambda: sizes(JArena))
    assert isinstance(mine, tuple) and mine == ref


@pytest.mark.parametrize("name,value", _values("PERSIA_WORKER_STREAMING"))
def test_worker_streaming(name, value, monkeypatch):
    from persia_tpu.config import EmbeddingSchema as JSchema
    from persia_tpu.config import uniform_slots as juniform
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    _set(monkeypatch, name, value)
    w = EmbeddingWorker(EmbeddingSchema(slots_config=uniform_slots(
        ["a"], dim=4)), [EmbeddingHolder(100, 1)])
    jw = JWorker(JSchema(slots_config=juniform(["a"], dim=4)),
                 [JHolder(100, 1)])
    try:
        assert w.streaming == jw.streaming
        # an explicit argument wins over the knob in both
        pinned = EmbeddingWorker(w.schema, w.ps_clients, streaming=True)
        assert pinned.streaming is True
        pinned.close()
    finally:
        w.close()


@pytest.mark.parametrize(
    "name,value", _values("PERSIA_ONLINE_APPLY_BATCH_ROWS")
    + _values("PERSIA_ONLINE_APPLY_ROWS_PER_SEC")
    + _values("PERSIA_ONLINE_SCAN_SEC"))
def test_online_knobs(name, value, monkeypatch, tmp_path):
    from persia_tpu.online import DeltaSubscriber as JSub
    from persia_tpu.serving import HotRowCache as JCache

    from persia_tpu_torch.online import DeltaSubscriber
    from persia_tpu_torch.serving import HotRowCache

    _set(monkeypatch, name, value)

    def settings(sub, cache):
        s = sub(cache(10, 1.0), str(tmp_path))
        return (s.batch_rows, s.governor.rows_per_sec,
                s.scan_interval_sec)

    mine, ref = _both(lambda: settings(DeltaSubscriber, HotRowCache),
                      lambda: settings(JSub, JCache))
    assert isinstance(mine, tuple) and mine == ref


# --- live routing: the uniform table, the rider, the reshard controller ---

ROUTING_OWN = {
    "PERSIA_ROUTING_SLOTS_PER_REPLICA": "16",
    "PERSIA_ROUTING_WIRE": "yes",
    "PERSIA_RESHARD_BATCH_ROWS": "128",
    "PERSIA_RESHARD_DRAIN_SEC": "0",
    "PERSIA_RESHARD_FREEZE_LEASE_SEC": "0.5",
    "PERSIA_RESHARD_JOURNAL_DIR": "journal",
    "PERSIA_RESHARD_RPC_TIMEOUT_SEC": "0",
    "PERSIA_RESHARD_STALE_RETRY_SEC": "2.5",
}


def _routing_values(name):
    return [pytest.param(
        name, v, id=f"{name}-{'unset' if v is UNSET else repr(v)}")
        for v in (UNSET, "", " 1", ROUTING_OWN[name])]


@pytest.mark.parametrize("name", sorted(ROUTING_OWN))
def test_routing_knob_is_registered_as_in_jax(name):
    from persia_tpu import knobs as jknobs

    mine, ref = tknobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)


def _routing_site(name, pkg):
    """What the knob's reading site does in package ``pkg``."""
    import time

    if pkg == "jax":
        from persia_tpu import reshard, routing
        from persia_tpu.service import ps_service
        from persia_tpu.worker.worker import EmbeddingWorker as W

        def stale_deadline():
            return W._stale_deadline(None)
    else:
        from persia_tpu_torch import reshard, routing
        from persia_tpu_torch.service import ps_service
        from persia_tpu_torch.worker.worker import EmbeddingWorker as W

        stale_deadline = W._stale_deadline
    if name == "PERSIA_ROUTING_SLOTS_PER_REPLICA":
        return routing.RoutingTable.uniform(2).num_slots
    if name == "PERSIA_ROUTING_WIRE":
        return ps_service.PsClient("127.0.0.1:1").routing_wire
    table = routing.RoutingTable.uniform(2, slots_per_replica=4)
    if name == "PERSIA_RESHARD_BATCH_ROWS":
        return reshard.ReshardController([], table).batch_rows
    if name == "PERSIA_RESHARD_JOURNAL_DIR":
        ctrl = reshard.ReshardController([], table)
        return None if ctrl.journal is None else ctrl.journal.root
    if name == "PERSIA_RESHARD_DRAIN_SEC":
        h = routing.RoutingHolder(table)
        h.apply(table.derive(table.replica_of_slot, 2))
        return h.prev is None  # the window expires at 2x the drain
    if name == "PERSIA_RESHARD_FREEZE_LEASE_SEC":
        return ps_service._ReshardState([0], 4, 2).lease_sec
    if name == "PERSIA_RESHARD_RPC_TIMEOUT_SEC":
        c = ps_service.PsClient("127.0.0.1:1", circuit_breaker=False)
        c.enable_reshard_deadline()
        return (getattr(c, "_reshard_rpc_deadline", None),
                c.client.enable_deadline)
    assert name == "PERSIA_RESHARD_STALE_RETRY_SEC"
    return round(stale_deadline() - time.monotonic(), 1)


@pytest.mark.parametrize(
    "name,value", [p for n in sorted(ROUTING_OWN)
                   for p in _routing_values(n)])
def test_routing_knobs(name, value, monkeypatch, tmp_path):
    """Each restored knob read where JAX reads it (``knobs.py:262-323``):
    the uniform table's slots, the client's rider, the controller's chunk
    and journal, the double-read window, the freeze lease, the reshard
    deadline, the stale-retry budget."""
    monkeypatch.chdir(tmp_path)  # a journal directory lands here
    _set(monkeypatch, name, value)
    mine, ref = _both(lambda: _routing_site(name, "port"),
                      lambda: _routing_site(name, "jax"))
    assert mine == ref
    assert not isinstance(mine, str) or name.endswith("JOURNAL_DIR"), mine


# --- orchestration: the launcher's entries, the fleet sizes, the autopilot --

ORCH_OWN = {
    "PERSIA_AUTOPILOT_COOLDOWN_SEC": "45.5",
    "PERSIA_AUTOPILOT_JOURNAL_DIR": "journal",
    "PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR": "4",
    "PERSIA_AUTOPILOT_MODE": "enforce",
    "PERSIA_DATALOADER_ENTRY": "send.py",
    "PERSIA_NN_WORKER_ENTRY": "train.py",
    "PERSIA_NUM_DATALOADERS": "3",
    "PERSIA_NUM_WORKERS": "2",
}


@pytest.mark.parametrize("name", sorted(ORCH_OWN))
def test_orchestration_knob_is_registered_as_in_jax(name):
    from persia_tpu import knobs as jknobs

    mine, ref = tknobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)


def _orch_site(name, pkg):
    """What the knob's reading site does in package ``pkg``: the pilot's
    posture, the launcher's child command line, or the knob's value where
    a manifest's role reads it."""
    import sys

    if pkg == "jax":
        from persia_tpu import autopilot, knobs, launcher
        from persia_tpu.fleet import FleetHistory
        from persia_tpu.slos import SloEngine
    else:
        from persia_tpu_torch import autopilot, knobs, launcher
        from persia_tpu_torch.fleet import FleetHistory
        from persia_tpu_torch.slos import SloEngine
    if name.startswith("PERSIA_AUTOPILOT_"):
        class Mon:
            engine, history, recorder = SloEngine(), FleetHistory(), None

        p = autopilot.Autopilot(Mon(), None, "job", policies=[])
        return (p.mode, p.cooldown_sec, p.max_actions_per_hour,
                p.journal.root)
    if name.endswith("_ENTRY"):
        role = ("data-loader" if name == "PERSIA_DATALOADER_ENTRY"
                else "nn-worker")
        calls = []

        class P:
            def wait(self):
                return 0

        def run(cmd, env=None):
            calls.append(cmd)
            return P()

        orig = launcher.run_command
        launcher.run_command = run
        try:
            try:
                launcher.main([role])
            except SystemExit as e:
                code = e.code
        finally:
            launcher.run_command = orig
        return [c[1:] for c in calls if c[0] == sys.executable], code
    return knobs.get(name)


@pytest.mark.parametrize(
    "name,value", [pytest.param(n, v, id=f"{n}-"
                                f"{'unset' if v is UNSET else repr(v)}")
                   for n in sorted(ORCH_OWN)
                   for v in (UNSET, "", " 1", ORCH_OWN[n])])
def test_orchestration_knobs(name, value, monkeypatch, tmp_path):
    """Each orchestration knob read where JAX reads it: the autopilot's
    mode (a bad one raises in both), cooldown, hourly limit and journal;
    the launcher's entry scripts (unset: ``SystemExit`` naming the knob);
    the fleet sizes a manifest hands its roles."""
    monkeypatch.chdir(tmp_path)  # a journal directory lands here
    monkeypatch.delenv("PERSIA_TRAINER_PROCESSES", raising=False)
    _set(monkeypatch, name, value)
    mine, ref = _both(lambda: _orch_site(name, "port"),
                      lambda: _orch_site(name, "jax"))
    assert mine == ref
