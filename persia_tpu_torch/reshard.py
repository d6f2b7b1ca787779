"""Live resharding (``persia_tpu/reshard.py``): the migration controller
that moves routing slots between PS replicas under traffic with zero lost
updates. Its row stream is the JAX package's byte for byte, so either
package's controller can migrate either package's replicas.

State machine per move group (one donor → one target, N slots):

    plan → copy → replay → freeze → cutover → drain

- **plan**: :func:`persia_tpu_torch.hotness.placement_plan` (or the uniform
  round-robin fallback) assigns the slot space across the desired
  replica count; :meth:`RoutingTable.moves_to` turns the delta into
  (donor, target, slots) move groups.
- **copy**: the donor snapshots the moving slots' rows through its
  backend's PSD v2 stream (``reshard_begin``) and the controller pipes
  bounded chunks to the target (``reshard_extract`` →
  ``reshard_install``). Writes keep landing on the donor; every
  written sign in a moving slot is **captured**.
- **replay**: captured signs drain to the target in rounds
  (``reshard_drain`` reads the rows' CURRENT donor state, so a sign
  captured five times replays once, with its latest value) until a
  round comes back small.
- **freeze**: the donor atomically stops accepting writes for the
  moving slots (in-flight write handlers are waited out), bouncing
  late writers with a typed ``routing_stale`` error they retry after
  the next epoch lands — the circuit breaker's cutover pattern,
  applied per slot.
- **cutover**: one final drain empties the capture set (the donor is
  now write-quiescent for those slots, so the read is definitive),
  then the successor routing table publishes: in-process workers via
  ``apply_routing``, fleets via the coordinator KV. Bounced writers
  observe the new epoch and re-split — nothing is lost, nothing
  applies twice.
- **drain**: donors keep the moved rows readable for the double-read
  window (in-flight lookups routed by the old epoch), then
  ``reshard_finish`` disarms capture; the stale rows age out of the
  donor's LRU/arena like any cold row.

Zero-lost-updates argument: every write to a moving slot either (a)
lands on the donor before freeze — then its sign is captured and its
final value replays to the target before the new epoch publishes — or
(b) bounces with ``routing_stale`` and re-applies on the target after
the epoch lands. The target accepts no writes for the moved slots
before the final replay completes (workers only route there under the
new epoch, which publishes after), so replay can never clobber a
post-cutover write. ``chip_smoke.py``'s ``reshard`` phase pins this with
a counting optimizer over a live 2→4→3 dance.
"""

import json
import logging
import os
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch import faults, knobs
from persia_tpu_torch.routing import RoutingTable

_logger = logging.getLogger(__name__)


class ReshardAborted(RuntimeError):
    """A migration aborted before ANY routing consumer saw the new
    epoch — the controller rolled the donors back to the old world and
    nothing diverged. Safe to retry after fixing the cause."""


# --- fencing ----------------------------------------------------------------
# Every reshard RPC carries a fencing token ``(epoch, attempt)``: the
# successor epoch orders migrations fleet-wide (strictly monotonic), the
# attempt counter orders retries of the SAME migration (a resumed
# controller bumps it). A donor/target remembers the highest token it
# ever saw and refuses anything lower with the typed error below, so a
# superseded controller — one whose journal a restart already resumed,
# or one racing a newer migration — can never freeze, drain, or disarm
# state it no longer owns. Tokens ride as plain request fields (no
# envelope extension): the reshard surface is only spoken mid-migration,
# so the idle wire stays byte-identical.

FENCED_PREFIX = "reshard_fenced:min_token="


class ReshardFenced(RuntimeError):
    """A replica refused a reshard RPC because it has already seen a
    newer fencing token — the calling controller is superseded and must
    stop (its migration was resumed or overtaken). NOT retryable with
    the same token. Carried over RPC as a plain RpcError whose message
    starts with :data:`FENCED_PREFIX`; :func:`is_reshard_fenced`
    recognizes both forms."""

    def __init__(self, min_token: Tuple[int, int], msg: str = ""):
        super().__init__(
            msg or f"{FENCED_PREFIX}{min_token[0]}.{min_token[1]}")
        self.min_token = (int(min_token[0]), int(min_token[1]))


def is_reshard_fenced(exc: BaseException) -> Optional[Tuple[int, int]]:
    """The minimum ``(epoch, attempt)`` token a fenced refusal demands,
    else None. Works on a local :class:`ReshardFenced` and on its
    RPC-flattened form (any exception whose message carries the
    prefix)."""
    if isinstance(exc, ReshardFenced):
        return exc.min_token
    msg = str(exc)
    at = msg.find(FENCED_PREFIX)
    if at < 0:
        return None
    tail = msg[at + len(FENCED_PREFIX):]
    head = ""
    for ch in tail:
        if not (ch.isdigit() or ch == "."):
            break
        head += ch
    parts = head.split(".")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        return None
    return (int(parts[0]), int(parts[1]))


# --- row stream format ------------------------------------------------------
# PSD-v1-shaped record stream: '<Q' row count, then per row
# '<QII' (sign, dim, vec_len) + vec_len f32s (value + optimizer state,
# widened to f32 by the donor's version-agnostic reader).
#
# The stream is naturally RUN-shaped: rows from one table share (dim,
# vec_len), so consecutive records have a constant stride. The codec
# exploits that — a run packs/unpacks as ONE (k, 16+4*len) uint8
# record-matrix memcpy instead of k struct.pack/frombuffer round trips
# — while the wire bytes stay identical to the per-row form (the
# fallback below IS the format's definition; the parity tests pin it).

# below this many same-shape rows the matrix setup costs more than the
# per-row loop it replaces
_RUN_VECTORIZE_MIN = 8


def _pack_run(signs: np.ndarray, dim: int, mat: np.ndarray) -> np.ndarray:
    """One same-shape run -> its record bytes (no count header):
    a (k, 16 + 4*len) uint8 record matrix filled column-wise."""
    k, ln = mat.shape
    rec = np.empty((k, 16 + 4 * ln), np.uint8)
    rec[:, 0:8] = signs.astype("<u8", copy=False).reshape(-1, 1) \
        .view(np.uint8)
    rec[:, 8:16] = np.frombuffer(
        struct.pack("<II", int(dim), ln), np.uint8)
    if ln:
        rec[:, 16:] = np.ascontiguousarray(mat, "<f4").view(np.uint8)
    return rec


def pack_row_runs(runs: List[Tuple[np.ndarray, int, np.ndarray]]) -> bytes:
    """Pack pre-grouped runs [(signs u64[k], dim, (k, len) f32)] —
    byte-identical to ``pack_rows`` over the concatenated rows."""
    total = sum(len(signs) for signs, _d, _m in runs)
    parts = [struct.pack("<Q", total)]
    for signs, dim, mat in runs:
        if len(signs):
            parts.append(_pack_run(signs, dim, mat).tobytes())
    return b"".join(parts)


def pack_rows(rows: Iterable[Tuple[int, int, np.ndarray]]) -> bytes:
    rows = rows if isinstance(rows, list) else list(rows)
    parts = [struct.pack("<Q", len(rows))]
    i, n = 0, len(rows)
    while i < n:
        dim, ln = int(rows[i][1]), len(rows[i][2])
        j = i + 1
        while j < n and int(rows[j][1]) == dim and len(rows[j][2]) == ln:
            j += 1
        if j - i >= _RUN_VECTORIZE_MIN:
            signs = np.fromiter((int(r[0]) for r in rows[i:j]),
                                np.uint64, j - i)
            mat = np.array([r[2] for r in rows[i:j]], np.float32) \
                if ln else np.empty((j - i, 0), np.float32)
            parts.append(_pack_run(signs, dim, mat).tobytes())
        else:
            for sign, d, vec in rows[i:j]:
                vec = np.ascontiguousarray(vec, np.float32)
                parts.append(struct.pack("<QII", int(sign), int(d),
                                         len(vec)))
                parts.append(vec.tobytes())
        i = j
    return b"".join(parts)


def unpack_row_runs(buf) -> List[Tuple[np.ndarray, int, np.ndarray]]:
    """Unpack to same-shape runs [(signs u64[k], dim, (k, len) f32)]:
    each run is one strided record-matrix slice — no per-row numpy
    allocation. Concatenating the runs reproduces ``unpack_rows``
    order; the returned arrays are fresh copies (safe past the frame
    buffer's lifetime)."""
    mv = memoryview(buf)
    if isinstance(buf, memoryview):
        buf = bytes(buf)  # np.frombuffer needs a buffer it can pin
    (n,) = struct.unpack_from("<Q", mv, 0)
    u8 = np.frombuffer(buf, np.uint8)
    end = len(mv)
    unpack_from = struct.unpack_from
    runs: List[Tuple[np.ndarray, int, np.ndarray]] = []
    off, left = 8, int(n)
    while left > 0:
        sign0, dim, ln = unpack_from("<QII", mv, off)
        stride = 16 + 4 * ln
        # extend the run while the NEXT record exists and shares shape
        k = 1
        while (k < left and off + (k + 1) * stride <= end
               and unpack_from("<II", mv, off + k * stride + 8)
               == (dim, ln)):
            k += 1
        block = u8[off:off + k * stride].reshape(k, stride)
        signs = block[:, 0:8].copy().view("<u8").reshape(k)
        mat = block[:, 16:].copy().view("<f4").reshape(k, ln) \
            if ln else np.empty((k, 0), np.float32)
        runs.append((signs, int(dim), mat))
        off += k * stride
        left -= k
    return runs


def unpack_rows(buf: bytes) -> List[Tuple[int, int, np.ndarray]]:
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    out = []
    for _ in range(n):
        sign, dim, ln = struct.unpack_from("<QII", buf, off)
        off += 16
        vec = np.frombuffer(buf, np.float32, count=ln, offset=off).copy()
        off += 4 * ln
        out.append((sign, dim, vec))
    return out


# --- planning ---------------------------------------------------------------


def plan_assignment(table: RoutingTable, num_replicas: int,
                    slot_weights: Optional[np.ndarray] = None,
                    ) -> np.ndarray:
    """Successor slot→replica assignment for ``num_replicas`` over the
    SAME slot space, minimizing movement.

    With ``slot_weights`` (per-slot traffic shares, e.g. from
    :func:`persia_tpu_torch.hotness.slot_weights`): greedy LPT with a mild
    keep-home bias — slots go heaviest-first to the least-loaded
    replica, staying with their current owner only when that owner is
    within a tenth of the slot's own weight of the argmin (movement is
    not free, but balance is the point; a generous tolerance here lets
    heavy slots pile up at home and hands back hash-even's skew).
    Without weights: existing slots on surviving replicas stay put and
    only the delta moves (scale-out steals the evenly-needed surplus;
    scale-in re-deals the dying replicas' slots)."""
    n = table.num_slots
    cur = table.replica_of_slot
    if slot_weights is not None:
        w = np.ascontiguousarray(slot_weights, np.float64)
        if len(w) != n:
            raise ValueError("slot_weights length != num_slots")
        out = np.empty(n, np.int32)
        load = np.zeros(num_replicas, np.float64)
        order = np.argsort(w, kind="stable")[::-1]
        for s in order:
            s = int(s)
            home = int(cur[s]) if int(cur[s]) < num_replicas else -1
            best = int(np.argmin(load))
            if home >= 0 and load[home] - load[best] <= 0.1 * w[s]:
                best = home
            out[s] = best
            load[best] += float(w[s])
        return out
    out = cur.astype(np.int32).copy()
    stranded = [int(s) for s in range(n) if out[s] >= num_replicas]
    counts = np.bincount(out[out < num_replicas], minlength=num_replicas)
    # re-deal stranded (scale-in) slots, then even out (scale-out):
    # every replica should end within 1 of n/num_replicas
    for s in stranded:
        r = int(np.argmin(counts))
        out[s] = r
        counts[r] += 1
    target = n // num_replicas
    overfull = [r for r in range(num_replicas) if counts[r] > target + 1
                or (counts[r] > target and np.any(counts < target))]
    for r in overfull:
        donors = [int(s) for s in range(n) if out[s] == r]
        while counts[r] > target and np.any(counts < target):
            s = donors.pop()
            to = int(np.argmin(counts))
            out[s] = to
            counts[r] -= 1
            counts[to] += 1
    return out


# --- durable migration journal ----------------------------------------------


class MigrationJournal:
    """Append-only migration state journal under one directory (local
    or ``hdfs://`` via :class:`~persia_tpu_torch.storage.PersiaPath` — the
    same atomic-rename discipline as spill packets and checkpoints).

    Each record is its own ``rec_<seq>_<kind>.json`` file written
    atomically, so a SIGKILL between any two protocol steps leaves a
    readable prefix — never a torn record. Kinds, in protocol order:

    - ``plan``       migration id, attempt, fencing epoch, old + new
                     table docs, move groups
    - ``copy_done``  per donor: snapshot copied + replay settled
    - ``frozen``     per donor: moving slots write-frozen
    - ``drained``    per donor: final (write-quiescent) capture drain
    - ``publish_start`` / ``published``  the cutover bracket
    - ``finalized``  double-read window closed, donors disarmed
    - ``aborted``    pre-publish rollback ran; old world intact
    - ``resume``     a restarted controller took over (attempt bump)

    :meth:`state` replays the records into the LATEST migration's
    summary — what :meth:`ReshardController.resume` keys its
    roll-forward/roll-back decision on."""

    def __init__(self, root: str):
        from persia_tpu_torch.storage import PersiaPath

        self.root = root
        PersiaPath(root).makedirs()
        self._lock = threading.Lock()
        self._seq = 0
        for rec in self._list_record_files():
            self._seq = max(self._seq, rec[0])

    def _list_record_files(self) -> List[Tuple[int, str]]:
        from persia_tpu_torch.storage import PersiaPath

        out = []
        for p in PersiaPath(self.root).listdir():
            name = os.path.basename(p)
            if (not name.startswith("rec_") or name.endswith(".tmp")
                    or not name.endswith(".json")):
                continue
            try:
                out.append((int(name.split("_")[1]), p))
            except (IndexError, ValueError):
                continue
        out.sort()
        return out

    def append(self, kind: str, **fields) -> dict:
        from persia_tpu_torch.storage import PersiaPath

        with self._lock:
            self._seq += 1
            seq = self._seq
        rec = {"seq": seq, "kind": kind, "ts": time.time(), **fields}
        # attempt + pid in the name make concurrent writers (a fenced
        # zombie controller and its resumed successor both appending to
        # the shared journal) collide into DISTINCT files instead of
        # silently replacing each other's records; state()'s attempt
        # filter then discards the zombie's
        path = os.path.join(
            self.root,
            f"rec_{seq:06d}_a{int(fields.get('attempt', 0)):03d}"
            f"_p{os.getpid()}_{kind}.json")
        PersiaPath(path).write_bytes_atomic(
            json.dumps(rec, sort_keys=True).encode("utf-8"))
        return rec

    def records(self) -> List[dict]:
        from persia_tpu_torch.storage import PersiaPath

        out = []
        for _seq, p in self._list_record_files():
            out.append(json.loads(PersiaPath(p).read_bytes()
                                  .decode("utf-8")))
        # same-seq records from concurrent writers order by attempt
        # (the superseded attempt sorts first and gets filtered)
        out.sort(key=lambda r: (int(r.get("seq", 0)),
                                int(r.get("attempt", 0) or 0)))
        return out

    # terminal phases: the migration needs nothing from a restarted
    # controller
    TERMINAL = ("finalized", "aborted")

    def state(self) -> Optional[dict]:
        """Summary of the LATEST migration in the journal (None when no
        ``plan`` was ever recorded): mig_id, attempt, epoch, table docs,
        per-donor progress sets, and ``phase`` — one of ``planned``,
        ``copying``, ``frozen``, ``publishing``, ``published``,
        ``finalized``, ``aborted``."""
        cur: Optional[dict] = None
        for rec in self.records():
            kind = rec["kind"]
            if (cur is not None
                    and rec.get("mig_id") == cur["mig_id"]
                    and rec.get("attempt") is not None
                    and int(rec["attempt"]) < cur["attempt"]):
                # a superseded attempt's straggler (a fenced-out zombie
                # controller still appends its rollback records to the
                # shared journal): its view of the migration is stale —
                # the RPC plane already refused it, the journal must too
                continue
            if kind == "plan":
                cur = {
                    "mig_id": rec["mig_id"],
                    "attempt": int(rec.get("attempt", 0)),
                    "epoch": int(rec["epoch"]),
                    "old_table": rec["old_table"],
                    "new_table": rec["new_table"],
                    "moves": rec.get("moves", []),
                    "copied": [], "frozen": [], "drained": [],
                    "phase": "planned",
                }
                continue
            if cur is None:
                continue
            if kind == "resume":
                cur["attempt"] = int(rec.get("attempt", cur["attempt"]))
            elif kind == "copy_done":
                cur["copied"].append(int(rec["donor"]))
                cur["phase"] = "copying"
            elif kind == "frozen":
                cur["frozen"].append(int(rec["donor"]))
                cur["phase"] = "frozen"
            elif kind == "drained":
                cur["drained"].append(int(rec["donor"]))
            elif kind == "publish_start":
                cur["phase"] = "publishing"
            elif kind == "published":
                cur["phase"] = "published"
            elif kind == "finalized":
                cur["phase"] = "finalized"
            elif kind == "aborted":
                cur["phase"] = "aborted"
        return cur


# --- controller -------------------------------------------------------------


class ReshardController:
    """Drives one resharding operation against a fleet of PS replicas
    speaking the ``reshard_*`` RPC surface (PsService; in-process
    holders wrapped in PsService work identically over loopback).

    ``workers`` is every routing consumer to swap at cutover — objects
    with ``apply_routing(table)`` / ``close_routing_window()`` (the
    EmbeddingWorker; RemoteEmbeddingWorker forwards the same calls).
    ``coordinator`` (optional CoordinatorClient) additionally publishes
    the table to the fleet KV for pull-side consumers."""

    def __init__(self, ps_clients: Sequence, table: RoutingTable,
                 workers: Sequence = (), coordinator=None,
                 batch_rows: Optional[int] = None,
                 replay_settle_rows: int = 256,
                 max_replay_rounds: int = 8,
                 drain_sec: Optional[float] = None,
                 journal_dir: Optional[str] = None,
                 mig_id: Optional[str] = None, attempt: int = 0,
                 phase_hook=None):
        self.ps_clients = list(ps_clients)
        self.table = table
        self.workers = list(workers)
        self.coordinator = coordinator
        self.drain_sec = drain_sec
        self.batch_rows = int(batch_rows if batch_rows is not None
                              else knobs.get("PERSIA_RESHARD_BATCH_ROWS"))
        self.replay_settle_rows = int(replay_settle_rows)
        self.max_replay_rounds = int(max_replay_rounds)
        # durable journal (None -> PERSIA_RESHARD_JOURNAL_DIR env, unset
        # = in-memory only, the pre-journal behavior): every protocol
        # transition is recorded atomically, so :meth:`resume` can roll
        # a crashed controller's migration forward or abort it cleanly
        if journal_dir is None:
            journal_dir = knobs.get("PERSIA_RESHARD_JOURNAL_DIR")
        self.journal = (MigrationJournal(journal_dir)
                        if journal_dir else None)
        # fencing identity: mig_id names the migration (journal + RPC
        # observability); (epoch, attempt) is the fencing token — a
        # resumed controller bumps attempt, fencing out the dead one's
        # stragglers (retried RPCs still in kernel buffers, a zombie
        # process that was only paused)
        self.mig_id = mig_id
        self.attempt = int(attempt)
        # chaos seam: called at each protocol transition as
        # ``phase_hook(state, **kw)`` AFTER the reshard.controller
        # faults site fires — a chaos harness snipes an actor at an
        # exact protocol state through it
        self._phase_hook = phase_hook
        self._fence_epoch = table.epoch
        self._finalize_lock = threading.Lock()
        self._pending_finish: List[Tuple[int, List[int]]] = []
        # progress metrics (the fleet scrapes these off whichever
        # process hosts the controller)
        from persia_tpu_torch.metrics import default_registry

        reg = default_registry()
        self._g_epoch = reg.gauge(
            "reshard_controller_epoch",
            help_text="routing epoch last published by this controller")
        self._g_active = reg.gauge(
            "reshard_active",
            help_text="1 while a slot migration is in flight")
        self._c_moved = reg.counter(
            "reshard_moved_rows_total",
            help_text="rows copied donor->target across all migrations")
        self._c_replayed = reg.counter(
            "reshard_replayed_rows_total",
            help_text="captured-write rows replayed donor->target")
        self._c_bounced = reg.counter(
            "reshard_moves_total",
            help_text="(donor, target) slot move groups completed")

    # -- protocol plumbing ------------------------------------------------

    @property
    def fence(self) -> Tuple[int, int]:
        """This attempt's fencing token (set by :meth:`execute`)."""
        return (self._fence_epoch, self.attempt)

    def _phase(self, state: str, **kw):
        """One protocol transition: fire the ``reshard.controller``
        faults site (a PERSIA_FAULTS spec or a chaos harness's
        ``die`` rule can SIGKILL the controller at an exact state),
        then a chaos harness's phase hook."""
        if faults._active:
            faults.fire("reshard.controller", state=state, **kw)
        if self._phase_hook is not None:
            self._phase_hook(state, **kw)

    def _journal(self, kind: str, **fields):
        if self.journal is not None:
            self.journal.append(kind, mig_id=self.mig_id,
                                attempt=self.attempt, **fields)

    def _arm_deadlines(self):
        """Bound every reshard RPC by PERSIA_RESHARD_RPC_TIMEOUT_SEC:
        clients that support it negotiate the ``__deadline__`` envelope
        slot on their next dial (the controller's own connection), so a
        wedged donor sheds the expired extract/install instead of
        hanging the migration. Idle fleets never reach here — their
        wire stays byte-identical."""
        for c in self.ps_clients:
            arm = getattr(c, "enable_reshard_deadline", None)
            if arm is not None:
                arm()

    def _heartbeat_donors(self, donors, stop: threading.Event):
        """Renew every armed donor's freeze lease while the migration
        runs: the copy loop's own RPCs only touch ONE donor at a time,
        so in a multi-donor migration a previously-processed donor
        would otherwise go un-renewed for its siblings' whole
        copy+replay phases and auto-thaw mid-migration. A fenced
        reshard_status doubles as the heartbeat; errors are ignored
        (the protocol RPCs surface real failures)."""
        lease = float(knobs.get("PERSIA_RESHARD_FREEZE_LEASE_SEC"))
        interval = max(0.5, lease / 3.0) if lease > 0 else 5.0
        while not stop.wait(interval):
            for d in donors:
                try:
                    self.ps_clients[d].reshard_status(fence=self.fence)
                except Exception:
                    pass

    def _fenced_finish(self, donor: int):
        """Best-effort donor disarm under this attempt's fence; a
        ReshardFenced refusal means a NEWER controller owns the donor —
        its state is not ours to clear."""
        try:
            self.ps_clients[donor].reshard_finish(fence=self.fence,
                                                  mig_id=self.mig_id)
        except Exception as e:
            if is_reshard_fenced(e) is not None:
                _logger.warning(
                    "reshard: donor %d is owned by a newer controller "
                    "(%s); leaving its state alone", donor, e)
            else:
                _logger.warning("reshard_finish on donor %d failed: %s",
                                donor, e)

    # -- public entry points ----------------------------------------------

    def reshard_to(self, num_replicas: int,
                   slot_weights: Optional[np.ndarray] = None,
                   new_ps_clients: Optional[Sequence] = None,
                   ) -> RoutingTable:
        """Scale/rebalance to ``num_replicas`` (hotness-balanced when
        ``slot_weights`` is given). ``new_ps_clients`` replaces the
        replica client list when the fleet grew; it must cover every
        replica the successor table references. Returns the published
        table."""
        if new_ps_clients is not None:
            self.ps_clients = list(new_ps_clients)
        if num_replicas > len(self.ps_clients):
            raise ValueError(
                f"cannot reshard to {num_replicas} replicas with only "
                f"{len(self.ps_clients)} PS clients")
        assignment = plan_assignment(self.table, num_replicas,
                                     slot_weights)
        new_table = self.table.derive(assignment, num_replicas,
                                      weights=slot_weights)
        return self.execute(new_table)

    def execute(self, new_table: RoutingTable) -> RoutingTable:
        """Run the full plan → copy → replay → freeze → cutover for an
        explicit successor table. Donor cleanup (the drain step) is
        deferred to :meth:`finalize` so the double-read window stays
        open for in-flight old-epoch readers."""
        # migrations serialize fleet-wide: the PREVIOUS epoch's frozen
        # donor states must clear before new moves begin — a slot that
        # moves BACK to a prior donor would otherwise bounce against
        # that donor's stale frozen mask forever
        if self._pending_finish:
            _logger.info("reshard: finalizing previous migration before "
                         "epoch %d begins", new_table.epoch)
            self.finalize()
        moves = self.table.moves_to(new_table)
        if self.mig_id is None:
            self.mig_id = f"m{new_table.epoch}-{os.urandom(4).hex()}"
        self._fence_epoch = new_table.epoch
        self._arm_deadlines()
        self._journal("plan", epoch=new_table.epoch,
                      old_table=self.table.to_doc(),
                      new_table=new_table.to_doc(), moves=moves)
        self._g_active.set(1)
        t0 = time.perf_counter()
        frozen: List[Tuple[int, List[int]]] = []
        by_donor: Dict[int, List[Dict]] = {}
        for mv in moves:
            by_donor.setdefault(mv["donor"], []).append(mv)
        hb_stop = threading.Event()
        hb = threading.Thread(
            target=self._heartbeat_donors,
            args=(sorted(by_donor), hb_stop),
            daemon=True, name="reshard-lease-heartbeat")
        hb.start()
        try:
            # copy + replay per donor (all of a donor's outgoing slots
            # snapshot in ONE pass over its store)
            for donor, donor_moves in sorted(by_donor.items()):
                self._copy_and_replay(donor, donor_moves, new_table)
                self._journal("copy_done", donor=donor)
            # freeze every donor, then final-drain each: after this
            # loop no write for a moved slot can land anywhere
            for donor, donor_moves in sorted(by_donor.items()):
                slots = sorted(s for mv in donor_moves
                               for s in mv["slots"])
                self.ps_clients[donor].reshard_freeze(
                    new_table.epoch, fence=self.fence,
                    mig_id=self.mig_id)
                frozen.append((donor, slots))
                self._journal("frozen", donor=donor, slots=slots)
                self._phase("freeze", donor=donor)
                self._final_drain(donor, donor_moves, new_table)
                self._journal("drained", donor=donor)
        except BaseException:
            # pre-publish rollback is SAFE: no worker has seen the new
            # epoch, so unfreezing every touched donor — frozen ones
            # AND armed-but-unfrozen ones whose copy failed midway —
            # restores exactly the old, still-routed-by world
            hb_stop.set()
            for donor in by_donor:
                self._fenced_finish(donor)
            self._journal("aborted", reason="pre-publish failure")
            self._g_active.set(0)
            raise
        # cutover: publish the successor epoch everywhere. From here
        # rollback is NOT safe — once any worker routes by the new
        # epoch, unfreezing donors would let old-epoch writers diverge
        # from the target copies — so a partial publish leaves the
        # donors frozen (bounced writers keep re-trying / failing
        # loudly) and raises for the operator; a restarted controller
        # resumes from the publish_start record by ROLLING FORWARD
        # (re-publish is idempotent).
        self._phase("cutover")
        self._journal("publish_start", epoch=new_table.epoch)
        try:
            self._publish(new_table)
        except ReshardAborted:
            # zero consumers applied: the old world is intact, so the
            # pre-publish rollback is still safe
            hb_stop.set()
            for donor in by_donor:
                self._fenced_finish(donor)
            self._journal("aborted", reason="publish reached no consumer")
            self._g_active.set(0)
            raise
        except BaseException:
            _logger.error(
                "reshard cutover for epoch %d failed MID-PUBLISH: "
                "donors stay frozen (do NOT reshard_finish them by "
                "hand unless every routing consumer is confirmed on "
                "the old epoch); resume() from the journal re-publishes "
                "idempotently, or re-run execute() with the same table",
                new_table.epoch)
            hb_stop.set()
            self._g_active.set(0)
            raise
        hb_stop.set()
        self._journal("published", epoch=new_table.epoch)
        with self._finalize_lock:
            self._pending_finish.extend(frozen)
        self.table = new_table
        self._g_active.set(0)
        self._c_bounced.inc(len(moves))
        self._phase("drain")
        _logger.info(
            "reshard to epoch %d done in %.2fs (%d move groups)",
            new_table.epoch, time.perf_counter() - t0, len(moves))
        return new_table

    def finalize(self, drain_sec: Optional[float] = None):
        """Close the double-read window: wait out ``drain_sec`` (knob
        default) for in-flight old-epoch lookups, disarm every frozen
        donor's capture state, and drop the workers' predecessor
        tables."""
        if drain_sec is None:
            drain_sec = (self.drain_sec if self.drain_sec is not None
                         else float(knobs.get("PERSIA_RESHARD_DRAIN_SEC")))
        with self._finalize_lock:
            pending, self._pending_finish = self._pending_finish, []
        if not pending:
            return
        if drain_sec > 0:
            time.sleep(drain_sec)
        for donor, _slots in pending:
            self._fenced_finish(donor)
        for w in self.workers:
            close = getattr(w, "close_routing_window", None)
            if close is not None:
                close()
        self._journal("finalized")

    # -- phases -----------------------------------------------------------

    def _copy_and_replay(self, donor: int, donor_moves: List[Dict],
                         new_table: RoutingTable):
        slots = sorted(s for mv in donor_moves for s in mv["slots"])
        target_of_slot = {s: mv["target"] for mv in donor_moves
                          for s in mv["slots"]}
        client = self.ps_clients[donor]
        total = client.reshard_begin(slots, new_table.num_slots,
                                     new_table.epoch, fence=self.fence,
                                     mig_id=self.mig_id)
        self._phase("copy", donor=donor)
        copied = 0
        while True:
            chunk, done = client.reshard_extract(self.batch_rows,
                                                 fence=self.fence)
            if chunk:
                copied += self._install(chunk, target_of_slot, new_table)
            if done:
                break
        self._c_moved.inc(copied)
        _logger.info("reshard: donor %d copied %d/%s rows for %d slots",
                     donor, copied, total, len(slots))
        # replay rounds: captured writes accumulated during the copy
        self._phase("replay", donor=donor)
        for _ in range(self.max_replay_rounds):
            chunk = client.reshard_drain(fence=self.fence)
            n = self._install(chunk, target_of_slot, new_table)
            self._c_replayed.inc(n)
            if n <= self.replay_settle_rows:
                return
        _logger.warning(
            "reshard: donor %d capture set not settling after %d "
            "rounds; the freeze window will absorb the rest",
            donor, self.max_replay_rounds)

    def _final_drain(self, donor: int, donor_moves: List[Dict],
                     new_table: RoutingTable):
        target_of_slot = {s: mv["target"] for mv in donor_moves
                          for s in mv["slots"]}
        # the donor is frozen: this read is definitive
        chunk = self.ps_clients[donor].reshard_drain(fence=self.fence)
        n = self._install(chunk, target_of_slot, new_table)
        self._c_replayed.inc(n)

    def _install(self, chunk: bytes, target_of_slot: Dict[int, int],
                 new_table: RoutingTable) -> int:
        if isinstance(chunk, (bytes, bytearray, memoryview)):
            runs = unpack_row_runs(chunk)
        else:
            rows = list(chunk)
            runs = [(np.array([r[0]], np.uint64), int(r[1]),
                     np.ascontiguousarray(r[2], np.float32).reshape(1, -1))
                    for r in rows]
        if not runs:
            return 0
        # route whole runs, not rows: per run, one vectorized slot hash
        # + one target map, then mask-partition the record matrix — the
        # per-target streams keep scan order, so the installed bytes
        # match the old per-row regrouping exactly
        tgt_of = np.full(new_table.num_slots, -1, np.int64)
        for slot, tgt in target_of_slot.items():
            tgt_of[slot] = tgt
        by_target: Dict[int, List] = {}
        installed = 0
        for signs, dim, mat in runs:
            if not len(signs):
                continue
            tgts = tgt_of[new_table.slot_of(signs)]
            for tgt in np.unique(tgts):
                tgt = int(tgt)
                if tgt < 0:
                    # a captured sign outside the moving set (possible
                    # when one capture set serves several move
                    # groups): skip
                    continue
                sel = tgts == tgt
                by_target.setdefault(tgt, []).append(
                    (signs[sel], dim, mat[sel]))
                installed += int(sel.sum())
        for tgt, tgt_runs in by_target.items():
            self.ps_clients[tgt].reshard_install(pack_row_runs(tgt_runs),
                                                 fence=self.fence,
                                                 mig_id=self.mig_id)
        return installed

    def _publish(self, table: RoutingTable):
        applied = 0
        refused = 0
        first_error: Optional[BaseException] = None
        for w in self.workers:
            try:
                if getattr(w, "addrs", None) is not None:
                    # remote worker fleet: ships addresses, each
                    # replica dials its own clients
                    ok = w.apply_routing(table, ps_addrs=[
                        c.addr for c in self.ps_clients])
                else:
                    ok = w.apply_routing(table,
                                         ps_clients=self.ps_clients)
            except BaseException as e:
                first_error = first_error or e
                # a partial broadcast (RemoteEmbeddingWorker fleet)
                # reports whether ANY of its replicas applied — that
                # poisons the zero-applied rollback just like a full
                # consumer applying
                if getattr(e, "applied_any", False):
                    applied += 1
                continue
            if not ok and getattr(w, "routing_epoch", -1) == table.epoch:
                # idempotent duplicate: the consumer already routes by
                # EXACTLY this epoch — a resumed controller's
                # re-publish, or a delayed duplicate delivery. Counting
                # it as refused would spuriously abort a migration that
                # in fact fully published. A consumer PAST this epoch
                # stays refused: re-publishing a retired table (a stale
                # journal resumed after a newer migration) must abort,
                # not roll the fleet's KV back.
                applied += 1
                continue
            applied += 1 if ok else 0
            refused += 0 if ok else 1
        if first_error is not None or refused:
            if applied == 0:
                # nobody routes by the new epoch: execute() may safely
                # roll the donors back to the old world
                raise ReshardAborted(
                    f"routing epoch {table.epoch} reached no routing "
                    f"consumer ({refused} refused as stale — the fleet "
                    f"may already be PAST this epoch; rebuild the "
                    f"controller from the live table via "
                    f"/fleet/routing — first error: {first_error!r})")
            raise RuntimeError(
                f"routing epoch {table.epoch} published to only "
                f"{applied}/{len(self.workers)} consumers "
                f"({refused} refused, first error: {first_error!r})")
        if self.coordinator is not None:
            from persia_tpu_torch.routing import publish_to_coordinator

            publish_to_coordinator(self.coordinator, table)
        for c in self.ps_clients:
            note = getattr(c, "set_routing_epoch", None)
            if note is not None:
                try:
                    note(table.epoch)
                except Exception:
                    pass
        self._g_epoch.set(table.epoch)
        _logger.info("routing epoch %d published to %d workers%s",
                     table.epoch, len(self.workers),
                     " + coordinator" if self.coordinator else "")

    # -- crash recovery ----------------------------------------------------

    @classmethod
    def resume(cls, journal_dir: str, ps_clients: Sequence,
               workers: Sequence = (), coordinator=None,
               **ctor_kw) -> Tuple["ReshardController", str]:
        """Reconstruct a crashed controller from its journal and drive
        its migration to a consistent end state. Returns ``(controller,
        action)`` where action is one of:

        - ``"noop"``        — journal empty or last migration terminal
          (finalized/aborted): nothing in flight, controller built on
          the latest known table.
        - ``"republished"`` — the crash happened AT or AFTER the
          publish bracket (``publish_start`` seen): some consumer may
          already route by the new epoch, so rollback is unsafe and the
          resume ROLLS FORWARD — re-publish the committed epoch
          (idempotent: consumers already there count as applied),
          re-queue every planned donor for the drain, then
          :meth:`finalize` (the caller decides the drain length).
        - ``"resumed"``     — the crash happened pre-publish: no
          consumer saw the new epoch, so the resume fences out the dead
          attempt (attempt + 1), disarms whatever donor state the old
          attempt left behind (a frozen donor's lease may already have
          thawed it — both are fine), and re-executes the SAME journaled
          plan from scratch. Installs are full-row writes, so re-copying
          partially-copied slots is idempotent.

        ``ps_clients`` must cover every replica the journaled successor
        table references (a restarted replica re-registers on a new
        address — build fresh clients from the coordinator)."""
        journal = MigrationJournal(journal_dir)
        st = journal.state()
        if st is None:
            raise ReshardAborted(
                f"journal {journal_dir!r} holds no migration plan; "
                f"nothing to resume")
        old_table = RoutingTable.from_doc(st["old_table"])
        new_table = RoutingTable.from_doc(st["new_table"])
        attempt = st["attempt"] + 1
        if st["phase"] in MigrationJournal.TERMINAL:
            table = (new_table if st["phase"] == "finalized"
                     else old_table)
            ctrl = cls(ps_clients, table, workers=workers,
                       coordinator=coordinator, journal_dir=journal_dir,
                       mig_id=st["mig_id"], attempt=st["attempt"],
                       **ctor_kw)
            return ctrl, "noop"
        ctrl = cls(ps_clients, old_table, workers=workers,
                   coordinator=coordinator, journal_dir=journal_dir,
                   mig_id=st["mig_id"], attempt=attempt, **ctor_kw)
        ctrl._journal("resume", from_phase=st["phase"])
        if st["phase"] in ("publishing", "published"):
            ctrl._republish(new_table, st)
            return ctrl, "republished"
        # pre-publish: fence out the dead attempt's donor state, then
        # re-run the same plan under the bumped token
        ctrl._fence_epoch = new_table.epoch
        ctrl._arm_deadlines()
        for mv in st["moves"]:
            ctrl._fenced_finish(int(mv["donor"]))
        _logger.warning(
            "reshard resume: re-executing migration %s (epoch %d) as "
            "attempt %d from journaled phase %r", st["mig_id"],
            new_table.epoch, attempt, st["phase"])
        ctrl.execute(new_table)
        return ctrl, "resumed"

    def _republish(self, new_table: RoutingTable, st: dict):
        """Post-publish roll-forward: the committed epoch is law — push
        it to every consumer again (idempotent), re-record the publish
        bracket, and queue every planned donor for the final disarm.
        The donors' frozen state (where their lease has not already
        thawed it) keeps bouncing old-epoch writers until the epoch
        reaches their workers, exactly as in the uncrashed flow."""
        self._fence_epoch = new_table.epoch
        self._arm_deadlines()
        self._g_active.set(1)
        try:
            self._publish(new_table)
        finally:
            self._g_active.set(0)
        self._journal("published", epoch=new_table.epoch)
        pending = [(int(mv["donor"]),
                    sorted(int(s) for s in mv["slots"]))
                   for mv in st["moves"]]
        with self._finalize_lock:
            self._pending_finish.extend(pending)
        self.table = new_table
        _logger.warning(
            "reshard resume: epoch %d re-published after a controller "
            "crash; finalize() will disarm %d donor(s)",
            new_table.epoch, len(pending))


def main():
    """The migration controller as a process (a chaos harness's actor
    and an operator escape hatch):

    ``python -m persia_tpu_torch.reshard --journal DIR --ps a:p,b:p,...
    --table table.json --to N [--die-at STATE] [--resume]``

    Publishes only to the PS tier (``set_routing_epoch``) and, when
    given, the coordinator KV; in-process workers belong to whoever
    resumes/finalizes from the journal afterwards. ``--die-at`` arms a
    ``reshard.controller:die`` fault rule so the process SIGKILLs
    itself at an exact protocol state — the chaos matrix's controller
    kills."""
    import argparse

    from persia_tpu_torch.service.ps_service import PsClient

    p = argparse.ArgumentParser()
    p.add_argument("--journal", required=True)
    p.add_argument("--ps", required=True,
                   help="comma-joined PS replica addresses, index order")
    p.add_argument("--table", default=None,
                   help="current RoutingTable doc (JSON file); optional "
                        "with --resume (the journal carries the tables)")
    p.add_argument("--to", type=int, default=None,
                   help="target replica count for a fresh migration")
    p.add_argument("--resume", action="store_true",
                   help="resume/abort the journaled migration instead "
                        "of planning a fresh one")
    p.add_argument("--die-at", default=None,
                   choices=["copy", "replay", "freeze", "cutover",
                            "drain"],
                   help="SIGKILL this process at the named protocol "
                        "state (chaos harness)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--drain-sec", type=float, default=None)
    args = p.parse_args()
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())
    clients = [PsClient(a, circuit_breaker=False)
               for a in args.ps.split(",") if a]
    coordinator = None
    if args.coordinator:
        from persia_tpu_torch.service.coordinator import CoordinatorClient

        coordinator = CoordinatorClient(args.coordinator)
    if args.die_at:
        faults.add("reshard.controller", "die", state=args.die_at)
    if args.resume:
        ctrl, action = ReshardController.resume(
            args.journal, clients, coordinator=coordinator,
            drain_sec=args.drain_sec)
        _logger.info("reshard controller process: resume -> %s (epoch %d)", action,
                     ctrl.table.epoch)
        if action != "noop":
            ctrl.finalize()
        return
    with open(args.table) as f:
        table = RoutingTable.from_doc(json.load(f))
    ctrl = ReshardController(clients, table, coordinator=coordinator,
                             journal_dir=args.journal,
                             drain_sec=args.drain_sec)
    new_table = ctrl.reshard_to(args.to)
    _logger.info("reshard controller process: migrated to epoch %d "
                 "(%d replicas); finalize deferred to the resuming "
                 "owner", new_table.epoch, new_table.num_replicas)


if __name__ == "__main__":
    main()
