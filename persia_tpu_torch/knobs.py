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
Each knob carries the JAX package's description and its
``import_time_safe`` flag; :func:`render_markdown` renders the port's
registry as a reference table, as the JAX package renders its
``docs/KNOBS.md``.
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
    doc: str
    # True: reading this knob at module import time is a deliberate,
    # documented freeze; every other knob is read at call time
    import_time_safe: bool = False


def _k(name, type_, default, doc, **kw) -> Knob:
    return Knob(name, type_, default, doc, **kw)


# One entry a knob, alphabetical, with the JAX package's text:
# render_markdown() prints it for an operator.
REGISTRY: Dict[str, Knob] = {k.name: k for k in [
    _k("PERSIA_ARENA_INDEX_SLOTS", "int", 1024,
       "Initial open-addressing sign-index size per internal shard of "
       "the arena holder (rounded up to a power of two; the index "
       "grows itself past 3/4 fill). Pre-size it near 2x the expected "
       "per-shard rows to skip rehash churn during the first fill."),
    _k("PERSIA_ARENA_SLAB_ROWS", "int", 65536,
       "Arena growth quantum: rows added per slab extension of a "
       "(shard, record-class) arena in the Python holder (amortized-"
       "doubling, so large stores reallocate O(log n) times). The "
       "native store's slab size is fixed at 4096 rows/slab."),
    _k("PERSIA_AUTOPILOT_COOLDOWN_SEC", "float", 300.0,
       "Default per-policy cooldown between executed autopilot actions "
       "of the same kind. A policy may override it; raising it is the "
       "first stabilizer when the action journal shows oscillation "
       "(scale_out closely followed by scale_in)."),
    _k("PERSIA_AUTOPILOT_JOURNAL_DIR", "str", None,
       "Directory for the autopilot's durable action journal "
       "(decision/executed/outcome records, atomic JSON files — same "
       "discipline as the reshard journal). None keeps the journal "
       "in-memory only: decisions are still queryable over HTTP but do "
       "not survive the process."),
    _k("PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR", "int", 12,
       "Global autopilot action-rate limiter across ALL policies: "
       "further actions (and recommendations) are deferred once this "
       "many fired in the trailing hour. The blast-radius backstop "
       "when a bad signal makes every policy want to act at once."),
    _k("PERSIA_AUTOPILOT_MODE", "str", "recommend",
       "Autopilot posture: `recommend` (default) journals every "
       "decision it WOULD take without touching the fleet; `enforce` "
       "executes decisions through the operator. Graduate only after "
       "a recommend soak matches operator intent (DEPLOY.md runbook)."),
    _k("PERSIA_COORDINATOR_ADDR", "str", "127.0.0.1:23333",
       "Address of the persia-coordinator control-plane service (the "
       "NATS analogue). Service binaries take it as their argparse "
       "default; client helpers fall back to the canonical default."),
    _k("PERSIA_DATALOADER_ENTRY", "str", None,
       "Script the `persia_tpu.launcher data-loader` role runs when no "
       "script argument is given (declarative k8s manifests)."),
    _k("PERSIA_DEADLOCK_DETECTION", "bool", False,
       "Arm the stall watchdog thread: logs an error when in-flight "
       "work stops heartbeating (reference env gate)."),
    _k("PERSIA_ENABLE_MONITOR", "bool", False,
       "Embedding worker: estimate distinct ids per feature with an "
       "HLL gauge (extra per-batch hashing cost)."),
    _k("PERSIA_FAULTS", "str", None,
       "Fault-injection spec armed at import (e.g. "
       "`ps.lookup:delay:0.2:0.5`); subprocess service replicas "
       "inherit it through the environment. See faults.py.",
       import_time_safe=True),
    _k("PERSIA_FAULTS_RPC", "bool", False,
       "Expose the `__faults__` RPC control method so a live process "
       "can be re-armed remotely (chaos bench). Never on by default."),
    _k("PERSIA_FAULTS_SEED", "int", None,
       "Deterministic seed for the fault injector's RNG.",
       import_time_safe=True),
    _k("PERSIA_FLEET_HISTORY_POINTS", "int", 512,
       "Per-series point cap of the fleet monitor's in-memory history "
       "ring (oldest points drop first). Bounds memory per scraped "
       "series independently of the time window."),
    _k("PERSIA_FLEET_HISTORY_SEC", "float", 600.0,
       "Time-window retention of the fleet monitor's history ring: "
       "every scraped series keeps this many seconds of (t, value) "
       "points for /fleet/history, sustained()/trend() context, and "
       "autopilot evidence excerpts."),
    _k("PERSIA_FLEET_TARGETS", "str", "",
       "Static fleet-monitor scrape targets: comma-joined "
       "`name=host:port` pairs, merged with coordinator discovery."),
    _k("PERSIA_FORCE_PYTHON_MW", "bool", False,
       "Skip the native middleware kernels and use the numpy twins."),
    _k("PERSIA_FSYNC", "bool", True,
       "Durability of storage.PersiaPath.write_bytes_atomic on local "
       "paths: fsync the tmp file before the rename and the parent "
       "directory after it, so a machine crash cannot lose a record "
       "the caller was told is durable (migration journals, snapshot "
       "manifests, inc-packet markers). `0` trades that guarantee for "
       "write latency — process crashes are still safe, host/power "
       "crashes are not."),
    _k("PERSIA_HOTNESS", "bool", False,
       "Workload telemetry: arm per-table hotness sketches "
       "(Space-Saving top-K + count-min + HLL, per internal shard) on "
       "the PS lookup path, the `hotness` RPC / `/hotness` sidecar "
       "endpoint, and the negotiated gradient-staleness meta rider on "
       "the PS wire. Off (the default) keeps the wire byte-identical "
       "and the lookup path at one pointer test of overhead."),
    _k("PERSIA_HOTNESS_CM_DEPTH", "int", 4,
       "Count-min sketch depth (hash rows) per (table, shard) hotness "
       "cell."),
    _k("PERSIA_HOTNESS_CM_WIDTH", "int", 8192,
       "Count-min sketch width (cells per row) per (table, shard) "
       "hotness cell; the frequency upper-bound error scales as "
       "~total/width."),
    _k("PERSIA_HOTNESS_TOPK", "int", 512,
       "Space-Saving summary size per (table, internal shard); a "
       "replica's merged per-table top-K holds up to "
       "num_internal_shards * this many rows."),
    _k("PERSIA_HTTP_PORT", "int", 0,
       "Default observability sidecar port for the service binaries "
       "(0 = ephemeral, -1 = disabled)."),
    _k("PERSIA_METRICS_GATEWAY_ADDR", "str", None,
       "Prometheus push-gateway address for metrics.push_loop. Unset "
       "= pull-only via the /metrics sidecar."),
    _k("PERSIA_MULTIHOST_CACHE", "str", "off",
       "What a multi-process trainer (`jax.process_count() > 1`) does "
       "when the device-resident embedding cache is requested: `off` "
       "(default) negotiates down LOUDLY — the cache is disabled and "
       "the run continues on the PS-only hybrid path, because a pod "
       "job must not die on a cache knob; `refuse` keeps the historic "
       "hard error (the cache's sign->slot mapper and miss/evict host "
       "transfers are single-controller state)."),
    _k("PERSIA_NN_WORKER_ENTRY", "str", None,
       "Script the `persia_tpu.launcher nn-worker` role runs when no "
       "script argument is given."),
    _k("PERSIA_NUM_DATALOADERS", "int", 1,
       "Data-loader replica count (k8s manifests, examples' EOS "
       "accounting)."),
    _k("PERSIA_NUM_PS", "int", 1,
       "Parameter-server replica count the worker binary expects."),
    _k("PERSIA_NUM_WORKERS", "int", 1,
       "Embedding-worker replica count (k8s manifests, examples)."),
    _k("PERSIA_ONLINE_APPLY_BATCH_ROWS", "int", 8192,
       "Rows per hot-row-cache delta-apply batch of the serving "
       "online subscriber: each batch takes the cache lock once and "
       "checks the write-rate governor once. Smaller batches bound "
       "the per-apply predict stall; larger ones amortize the lock."),
    _k("PERSIA_ONLINE_APPLY_ROWS_PER_SEC", "int", 500_000,
       "Write-rate governor of the serving delta subscriber: a token "
       "bucket (1s burst) over rows upserted into the hot-row cache, "
       "so a training-tier flush burst spreads its applies instead of "
       "convoying the predict path (the --mode online bench gates "
       "serving p99 inflation at <= 3% with this armed). 0 = "
       "unthrottled."),
    _k("PERSIA_ONLINE_SCAN_SEC", "float", 2.0,
       "Scan interval of the serving delta subscriber over the "
       "incremental-update packet directory. Together with the "
       "trainer's flush cadence this bounds sign-to-servable lag; "
       "scans of an unchanged directory cost one listdir."),
    _k("PERSIA_POSTMORTEM_DIR", "str", None,
       "Where the fleet monitor / PS supervisor write breach and crash "
       "flight-recorder bundles. Unset = recorder disabled."),
    _k("PERSIA_PROCESS_COUNT", "int", 1,
       "Trainer-group size this process belongs to. Set by "
       "`persia_tpu.launcher nn-worker` on every spawned trainer copy "
       "(alongside PERSIA_PROCESS_INDEX); the trainer driver shards "
       "the deterministic batch stream by (index, count). 1 = the "
       "historic single-process stream."),
    _k("PERSIA_PROCESS_INDEX", "int", 0,
       "This trainer process's rank within the trainer group "
       "(0-based, < PERSIA_PROCESS_COUNT). Owns every global batch "
       "whose stream position i satisfies "
       "i % PERSIA_PROCESS_COUNT == index."),
    _k("PERSIA_PROFILE_DIR", "str", None,
       "Enables the step-windowed jax.profiler capture; traces land "
       "here."),
    _k("PERSIA_PROFILE_NUM_STEPS", "int", 5,
       "How many steps the profiler window captures."),
    _k("PERSIA_PROFILE_START_STEP", "int", 10,
       "First step of the profiler capture window."),
    _k("PERSIA_PS_BACKEND", "str", "auto",
       "Embedding-store backend: `auto` picks the native C++ arena "
       "store when the built library supports the configured storage "
       "policy (negotiating down to the Python arena holder LOUDLY "
       "when an older .so lacks a capability), `native` requires it, "
       "`arena` forces the Python arena holder, `python-legacy` forces "
       "the per-entry OrderedDict holder (A/B lever for bench.py "
       "--mode mem). Replaces the retired PERSIA_FORCE_PYTHON_PS."),
    _k("PERSIA_PS_CIRCUIT_BREAKER", "bool", True,
       "Per-replica circuit breaker on every PsClient RPC (fail fast "
       "while a background TCP probe watches the address). `0` "
       "disables."),
    _k("PERSIA_PS_CONCURRENT_STREAMS", "int", 8,
       "PS per-connection dispatch-pool depth (1 = the legacy "
       "strictly-serial per-connection loop)."),
    _k("PERSIA_PS_GC_TUNE", "bool", True,
       "PS replica: freeze boot state and make full GC ~100x rarer "
       "(a multi-million-entry store makes gen2 walks multi-hundred-ms "
       "stalls). `0` restores interpreter defaults."),
    _k("PERSIA_PS_LEGACY_FRAMES", "bool", False,
       "Revert PS request framing to the concatenating pack_arrays "
       "(pre-zero-copy A/B lever for the worker-cycle bench)."),
    _k("PERSIA_PS_ROW_DTYPE", "str", None,
       "Storage precision of the embedding slice of every PS row "
       "(fp32|fp16|bf16; optimizer state stays fp32). Served by every "
       "backend; an old pre-arena native .so negotiates down to the "
       "Python arena holder loudly."),
    _k("PERSIA_PS_SHARD_PARALLEL", "bool", True,
       "PS shard-parallel dispatch (per-internal-shard buckets). `0` "
       "forces single-threaded dispatch regardless of core count."),
    _k("PERSIA_PS_WIRE_CODEC", "str", "",
       "Embedding-row wire precision policy: ``fp16`` ships lookup "
       "responses as fp16 rows, ``fp16+int8`` additionally ships "
       "update gradients as int8 + per-row scales (error feedback "
       "client-side). Unset/off keeps the fp32 wire byte-identical to "
       "the legacy protocol."),
    _k("PERSIA_RESHARD_BATCH_ROWS", "int", 65536,
       "Rows per extract/install chunk while the reshard controller "
       "streams a donor's slot snapshot to its target replica. Smaller "
       "chunks bound the per-RPC copy stall a migrating replica "
       "imposes on live traffic; larger chunks finish the copy phase "
       "sooner."),
    _k("PERSIA_RESHARD_DRAIN_SEC", "float", 5.0,
       "Double-read window after a reshard cutover: donors keep the "
       "moved rows readable (for in-flight lookups routed by the "
       "previous epoch) this long before finalize deletes them. "
       "Raise it when trainers run deep async staleness windows."),
    _k("PERSIA_RESHARD_FREEZE_LEASE_SEC", "float", 30.0,
       "Donor self-healing lease on reshard state: every controller "
       "RPC (begin/extract/drain/freeze/status) renews it; when it "
       "expires — the controller died or was partitioned away — the "
       "donor auto-thaws, discarding capture state and unfreezing the "
       "moving slots, so bounced writers recover under the OLD epoch "
       "instead of facing a frozen-forever shard. Keep it well above "
       "the longest expected extract/install gap; a resumed controller "
       "fences out the dead attempt either way. 0 disables the lease "
       "(frozen state persists until reshard_finish)."),
    _k("PERSIA_RESHARD_JOURNAL_DIR", "str", None,
       "Arm the reshard controller's durable migration journal: "
       "append-only, atomically-written protocol records (plan, "
       "per-donor copy/freeze/drain, publish bracket, finalize/abort) "
       "land under this directory (storage.PersiaPath — local or "
       "hdfs://), so a controller killed mid-migration can resume() "
       "or abort the same migration after restart. Unset = in-memory "
       "only (a controller crash relies on the freeze lease for donor "
       "recovery)."),
    _k("PERSIA_RESHARD_RPC_TIMEOUT_SEC", "float", 120.0,
       "Per-RPC deadline the reshard controller stamps on every "
       "reshard_* call (negotiated __deadline__ envelope slot, armed "
       "on its clients at migration start): a wedged donor sheds the "
       "expired extract/install instead of hanging the migration "
       "unboundedly. Idle fleets never negotiate it — the "
       "no-migration wire stays byte-identical. 0 disables."),
    _k("PERSIA_RESHARD_STALE_RETRY_SEC", "float", 10.0,
       "How long a worker retries a shard group bounced with "
       "routing_stale (the reshard freeze window) while waiting for "
       "the new routing epoch to arrive before giving up. The freeze "
       "window is normally milliseconds; this bound only catches a "
       "wedged cutover."),
    _k("PERSIA_ROUTING_SLOTS_PER_REPLICA", "int", 64,
       "Routing slots per PS replica when a uniform table is born "
       "(num_slots = replicas * this). Slots are the migration unit: "
       "more slots = finer-grained hotness balancing and smaller "
       "migration chunks, at a few bytes of table per slot. The "
       "uniform table routes bit-exactly like the legacy "
       "farmhash % R whatever this value is."),
    _k("PERSIA_ROUTING_WIRE", "bool", False,
       "PsClient probes the __routing__ envelope extension at dial "
       "and stamps its routing epoch on lookup/update meta, letting a "
       "resharding PS fast-reject stale-epoch writes before the "
       "per-sign slot check. Off (default) keeps the wire "
       "byte-identical; legacy servers negotiate down."),
    _k("PERSIA_RPC_FORCE_BLOCK", "bool", False,
       "Force negotiated block compression even on loopback (tests and "
       "benches exercise the codec path without a real DCN link).",
       import_time_safe=True),
    _k("PERSIA_SKIP_CHECK_DATA", "bool", False,
       "Skip PersiaBatch input validation (shape/dtype checks) on the "
       "data-loader hot path. Read at call time — setting it after "
       "import works (the old import-time freeze was a bug)."),
    _k("PERSIA_SNAPSHOT_INTERVAL_STEPS", "int", 50,
       "Default cadence (train steps) between coordinated job "
       "snapshots taken by the supervised trainer driver "
       "(persia_tpu.service.trainer_service). The interval is the "
       "recovery budget: a trainer SIGKILL loses at most this many "
       "steps of dense+sparse progress, all of which the resume path "
       "replays deterministically from the snapshotted data cursor."),
    _k("PERSIA_SNAPSHOT_KEEP", "int", 3,
       "Retention of the job-snapshot GC (persia_tpu/snapshot.py): "
       "the newest K COMPLETE snapshots survive; older completes and "
       "any torn/manifest-less debris older than the newest complete "
       "are removed after each successful snapshot. Keep >= 2 so a "
       "torn newest snapshot always has a fallback."),
    _k("PERSIA_TIER_ADMIT", "str", "lru",
       "Device-cache admission policy for the HBM tier of the embedding "
       "ladder: `lru` (the legacy recency-only mapper) or `hotness` "
       "(frequency-gated admission — a Space-Saving sketch over the "
       "training id stream keeps one-touch cold traffic in a small "
       "probationary window so it cannot thrash the resident hot set). "
       "The default keeps the wire and the mapper behavior identical "
       "to the pre-ladder stack."),
    _k("PERSIA_TIER_SKETCH_TOPK", "int", 0,
       "Space-Saving summary size of the hotness-admitted device-cache "
       "mapper (0 = auto: 4x the cache capacity, capped at 1Mi). Only "
       "read when PERSIA_TIER_ADMIT=hotness."),
    _k("PERSIA_TIER_SPILL_BYTES", "int", 0,
       "Disk budget for the PS cold-row spill tier (0 = unbounded). "
       "When the budget overflows, whole oldest spill packets are "
       "dropped (cold-cold rows die last-tier)."),
    _k("PERSIA_TIER_SPILL_DIR", "str", None,
       "Arm the PS disk spill tier: byte/row-budget evictions write "
       "cold rows to spill packets under this directory "
       "(storage.PersiaPath — local or hdfs://) instead of dropping "
       "them, and lookups fault spilled rows back in transparently. "
       "Works on every backend (the native store drains evictions to "
       "the shared Python SpillStore)."),
    _k("PERSIA_TIER_WINDOW_FRAC", "float", 0.125,
       "Fraction of the device-cache capacity reserved as the "
       "probationary admission window under PERSIA_TIER_ADMIT=hotness "
       "(cold newcomers churn there; rows earn protected residency by "
       "out-counting the protected LRU victim)."),
    _k("PERSIA_TRACING", "bool", False,
       "Cross-tier span capture. Frozen at import ON PURPOSE: the "
       "disabled path must cost nothing, so the gate is a module "
       "constant; tests toggle via subprocess env.",
       import_time_safe=True),
    _k("PERSIA_TRAINER_PROCESSES", "int", 1,
       "Trainer (nn-worker) processes per job: `persia_tpu.launcher "
       "nn-worker` spawns this many copies of the entry script with "
       "PERSIA_PROCESS_INDEX/PERSIA_PROCESS_COUNT set, and "
       "ServiceCtx's trainer supervisor sizes its group from the same "
       "number. 1 = the historic single-process trainer."),
    # only a KV label: byte-equal to the JAX package's, so that a mixed
    # trainer group meets under one key
    _k("PERSIA_TRAINER_RENDEZVOUS_KEY", "str", "trainer/jax_coordinator",
       "Coordinator KV key the trainer group rendezvouses through: "
       "process 0 binds the jax.distributed coordination port and "
       "kv_put's `host:port` under this key; every other process "
       "wait_kv's it before jax.distributed.initialize."),
    _k("PERSIA_TRAINER_RENDEZVOUS_TIMEOUT_SEC", "float", 120.0,
       "How long a non-zero trainer process waits for process 0 to "
       "publish the jax.distributed coordinator address before giving "
       "up (coordinator KV wait_kv timeout)."),
    _k("PERSIA_VARIANT_ROUTE_FEATURE", "str", None,
       "Field-based A/B routing for the serving tier: when set, a "
       "plain predict derives its variant route key from this id "
       "feature's first sign (e.g. the user-id slot — per-user-sticky "
       "assignment with no client change). Unset keeps plain predicts "
       "on the default variant. Read once at server construction."),
    _k("PERSIA_VARIANT_SPLIT_BUCKETS", "int", 10000,
       "Resolution of the deterministic weighted variant split: route "
       "keys hash into this many buckets and variants own contiguous "
       "weight-proportional ranges. 10000 buckets = 0.01% split "
       "granularity; every serving replica computes the same "
       "assignment for the same key."),
    _k("PERSIA_WORKER_STREAMING", "bool", True,
       "Embedding worker streaming data plane (scatter-per-completion "
       "lookups, ship-as-aggregated updates). `0` restores the "
       "serialized gather-then-scatter plane."),
    _k("PERSIA_WORKLOAD_ALPHA", "float", 1.05,
       "Default zipf skew of the workload-zoo scenario generators "
       "(persia_tpu/workloads): every categorical table's sign draw "
       "uses this alpha unless the scenario spec overrides it. The "
       "e2e bench fits the hotness telemetry against traffic generated "
       "at this skew."),
    _k("PERSIA_WORKLOAD_SEED", "int", 0,
       "Base seed of the workload-zoo generators. Scenario streams are "
       "deterministic per seed (identical batches), and the hidden "
       "label structure is seed-INDEPENDENT — train on one seed, "
       "evaluate on another, same task."),
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


def all_knobs():
    return [REGISTRY[k] for k in sorted(REGISTRY)]


def render_markdown() -> str:
    """The port's knob reference: one table row a knob."""
    lines = [
        "# PERSIA_* environment knobs",
        "",
        "Generated from `persia_tpu_torch/knobs.py` — do not edit by hand.",
        "Print it with `python -c 'from persia_tpu_torch import knobs; "
        "print(knobs.render_markdown())'`.",
        "",
        "Boolean knobs whose default is **on** are disabled only by the",
        "literal `0`; boolean knobs whose default is **off** are enabled",
        "by `1`/`true`/`yes`. All knobs are read at call time unless",
        "marked *frozen at import*.",
        "",
        "| Knob | Type | Default | Description |",
        "|---|---|---|---|",
    ]
    for knob in all_knobs():
        default = ("*(unset)*" if knob.default is None
                   else f"`{knob.default}`")
        doc = " ".join(knob.doc.split())
        if knob.import_time_safe:
            doc += " *(frozen at import)*"
        lines.append(f"| `{knob.name}` | {knob.type} | {default} | {doc} |")
    lines.append("")
    return "\n".join(lines)
