"""The ``PERSIA_*`` environment knobs the port reads
(``persia_tpu/knobs.py``).

The knobs of the data layer (batch validation, the workload zoo's
seed and skew), the PS holders (the backend, the arena's growth quantum
and index size), the spill tier, the hotness sketches, the snapshot
retention, the storage layer's fsync, the device cache (its admission
policy, the hotness mapper's window and sketch, the multi-process
negotiation), the serving wire (the RPC block codec, fault injection,
tracing, the variant split, the observability sidecar and the metrics
push gateway), the online tier (the delta subscriber's scan interval,
apply batch and write-rate governor), the service tier (the
coordinator's address, the PS replica count, the PS service's dispatch,
wire codec, circuit breaker, frames, GC tune, row dtype and spill tier,
the worker's data plane and distinct-id monitor, the middleware's numpy
twins forced), whole-job supervision
(the trainer group's size, rank and rendezvous, the snapshot cadence),
the fleet monitor (its static targets, its history ring's window and
points a series, the postmortem directory), tooling (the step profiler's
window, the stall watchdog) and live routing (a uniform table's slots a
replica, the ``__routing__`` rider, the reshard controller's chunk,
drain, lease, journal, RPC deadline and the worker's stale-retry
budget) and orchestration (the launcher's entry scripts, the fleet sizes
a manifest hands its roles, the autopilot's mode, cooldown, hourly
action limit and journal), with the JAX package's names,
types, defaults and parse conventions:

- ``bool`` knobs whose default is False are enabled by ``1`` / ``true`` /
  ``yes`` (case-insensitive);
- ``bool`` knobs whose default is True are disabled only by the literal
  ``0``;
- ``int`` and ``float`` knobs parse with ``int()`` / ``float()``; unset or
  empty -> the default;
- ``str`` knobs are returned as they are set.

:func:`get` reads ``os.environ`` at call time; an unknown name raises.
:func:`get_raw` returns the environment string or the caller's fallback.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

_TRUTHY = ("1", "true", "yes")


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "bool" | "int" | "float" | "str"
    default: object


REGISTRY: Dict[str, Knob] = {k.name: k for k in [
    Knob("PERSIA_ARENA_INDEX_SLOTS", "int", 1024),
    Knob("PERSIA_ARENA_SLAB_ROWS", "int", 65536),
    Knob("PERSIA_AUTOPILOT_COOLDOWN_SEC", "float", 300.0),
    Knob("PERSIA_AUTOPILOT_JOURNAL_DIR", "str", None),
    Knob("PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR", "int", 12),
    Knob("PERSIA_AUTOPILOT_MODE", "str", "recommend"),
    Knob("PERSIA_COORDINATOR_ADDR", "str", "127.0.0.1:23333"),
    Knob("PERSIA_DATALOADER_ENTRY", "str", None),
    Knob("PERSIA_DEADLOCK_DETECTION", "bool", False),
    Knob("PERSIA_ENABLE_MONITOR", "bool", False),
    Knob("PERSIA_FAULTS", "str", None),
    Knob("PERSIA_FAULTS_RPC", "bool", False),
    Knob("PERSIA_FAULTS_SEED", "int", None),
    Knob("PERSIA_FLEET_HISTORY_POINTS", "int", 512),
    Knob("PERSIA_FLEET_HISTORY_SEC", "float", 600.0),
    Knob("PERSIA_FLEET_TARGETS", "str", ""),
    Knob("PERSIA_FORCE_PYTHON_MW", "bool", False),
    Knob("PERSIA_FSYNC", "bool", True),
    Knob("PERSIA_HOTNESS", "bool", False),
    Knob("PERSIA_HOTNESS_CM_DEPTH", "int", 4),
    Knob("PERSIA_HOTNESS_CM_WIDTH", "int", 8192),
    Knob("PERSIA_HOTNESS_TOPK", "int", 512),
    Knob("PERSIA_HTTP_PORT", "int", 0),
    Knob("PERSIA_METRICS_GATEWAY_ADDR", "str", None),
    Knob("PERSIA_MULTIHOST_CACHE", "str", "off"),
    Knob("PERSIA_NN_WORKER_ENTRY", "str", None),
    Knob("PERSIA_NUM_DATALOADERS", "int", 1),
    Knob("PERSIA_NUM_PS", "int", 1),
    Knob("PERSIA_NUM_WORKERS", "int", 1),
    Knob("PERSIA_ONLINE_APPLY_BATCH_ROWS", "int", 8192),
    Knob("PERSIA_ONLINE_APPLY_ROWS_PER_SEC", "int", 500_000),
    Knob("PERSIA_ONLINE_SCAN_SEC", "float", 2.0),
    Knob("PERSIA_POSTMORTEM_DIR", "str", None),
    Knob("PERSIA_PROCESS_COUNT", "int", 1),
    Knob("PERSIA_PROCESS_INDEX", "int", 0),
    Knob("PERSIA_PROFILE_DIR", "str", None),
    Knob("PERSIA_PROFILE_NUM_STEPS", "int", 5),
    Knob("PERSIA_PROFILE_START_STEP", "int", 10),
    Knob("PERSIA_PS_BACKEND", "str", "auto"),
    Knob("PERSIA_PS_CIRCUIT_BREAKER", "bool", True),
    Knob("PERSIA_PS_CONCURRENT_STREAMS", "int", 8),
    Knob("PERSIA_PS_GC_TUNE", "bool", True),
    Knob("PERSIA_PS_LEGACY_FRAMES", "bool", False),
    Knob("PERSIA_PS_ROW_DTYPE", "str", None),
    Knob("PERSIA_PS_SHARD_PARALLEL", "bool", True),
    Knob("PERSIA_PS_WIRE_CODEC", "str", ""),
    Knob("PERSIA_RESHARD_BATCH_ROWS", "int", 65536),
    Knob("PERSIA_RESHARD_DRAIN_SEC", "float", 5.0),
    Knob("PERSIA_RESHARD_FREEZE_LEASE_SEC", "float", 30.0),
    Knob("PERSIA_RESHARD_JOURNAL_DIR", "str", None),
    Knob("PERSIA_RESHARD_RPC_TIMEOUT_SEC", "float", 120.0),
    Knob("PERSIA_RESHARD_STALE_RETRY_SEC", "float", 10.0),
    Knob("PERSIA_ROUTING_SLOTS_PER_REPLICA", "int", 64),
    Knob("PERSIA_ROUTING_WIRE", "bool", False),
    Knob("PERSIA_RPC_FORCE_BLOCK", "bool", False),
    Knob("PERSIA_SKIP_CHECK_DATA", "bool", False),
    Knob("PERSIA_SNAPSHOT_INTERVAL_STEPS", "int", 50),
    Knob("PERSIA_SNAPSHOT_KEEP", "int", 3),
    Knob("PERSIA_TIER_ADMIT", "str", "lru"),
    Knob("PERSIA_TIER_SKETCH_TOPK", "int", 0),
    Knob("PERSIA_TIER_SPILL_BYTES", "int", 0),
    Knob("PERSIA_TIER_SPILL_DIR", "str", None),
    Knob("PERSIA_TIER_WINDOW_FRAC", "float", 0.125),
    Knob("PERSIA_TRACING", "bool", False),
    Knob("PERSIA_TRAINER_PROCESSES", "int", 1),
    # only a KV label: byte-equal to the JAX package's, so that a mixed
    # trainer group meets under one key
    Knob("PERSIA_TRAINER_RENDEZVOUS_KEY", "str", "trainer/jax_coordinator"),
    Knob("PERSIA_TRAINER_RENDEZVOUS_TIMEOUT_SEC", "float", 120.0),
    Knob("PERSIA_VARIANT_ROUTE_FEATURE", "str", None),
    Knob("PERSIA_VARIANT_SPLIT_BUCKETS", "int", 10000),
    Knob("PERSIA_WORKER_STREAMING", "bool", True),
    Knob("PERSIA_WORKLOAD_ALPHA", "float", 1.05),
    Knob("PERSIA_WORKLOAD_SEED", "int", 0),
]}


def _parse(knob: Knob, raw: str):
    if knob.type == "bool":
        if knob.default:
            return raw != "0"
        return raw.lower() in _TRUTHY
    if knob.type in ("int", "float"):
        # an empty numeric knob means unset (shells interpolate unset
        # variables as "")
        if raw == "":
            return knob.default
        return int(raw) if knob.type == "int" else float(raw)
    return raw


def get(name: str):
    """Typed value of knob ``name`` from the current environment, or its
    default. Unknown names raise."""
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"unregistered PERSIA knob {name!r}; the port "
                       f"reads only {sorted(REGISTRY)}")
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return _parse(knob, raw)


def get_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The environment string of knob ``name``, or ``default`` when it is
    unset (for argparse defaults that must tell "unset" apart)."""
    if name not in REGISTRY:
        raise KeyError(f"unregistered PERSIA knob {name!r}")
    return os.environ.get(name, default)
