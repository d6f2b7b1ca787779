"""Versioned slot-based sign routing (``persia_tpu/routing.py``).

Every shard-routing decision (the worker's lookup and update fan-out,
the serving tier's miss fetches, checkpoint resharding, the replay of
incremental-update packets) goes through one :class:`RoutingTable`: an
epoch-stamped slot -> replica map over a fixed slot space::

    slot(sign)    = farmhash64(sign) % num_slots
    replica(sign) = replica_of_slot[slot(sign)]

A table born uniform has ``num_slots = num_replicas * slots_per_replica``
(``PERSIA_ROUTING_SLOTS_PER_REPLICA``, 64), so ``slot % num_replicas``
reproduces ``farmhash64(sign) % num_replicas`` bit-exactly: the wire, the
per-replica request counts and the checkpoint layout of a fleet that
never reshards are the legacy ones. Resharding keeps the slot space and
reassigns slots; the slot is the migration unit
(:mod:`persia_tpu_torch.reshard`).

A ``RoutingTable`` is immutable. Its holders (the worker, the serving
tier, the reshard controller) swap the reference under their own lock
and keep the predecessor for the double-read window (:class:`RoutingHolder`):
work routed by epoch N stays valid against the donors until the
migration's finalize, because donors keep the moved rows until then.
Epochs only grow: :meth:`RoutingTable.derive` stamps ``epoch + 1`` and
every ``apply_routing`` refuses a table whose epoch does not advance.
"""

import json
import logging
import threading
import time as _time
from typing import Dict, List, Optional, Sequence

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.hashing import farmhash64_np

_logger = logging.getLogger(__name__)

TABLE_VERSION = 1

# the coordinator KV key tables are published under (the reshard
# controller writes it at cutover; workers pull it)
COORDINATOR_KEY = "routing_table"

STALE_PREFIX = "routing_stale:min_epoch="


class RoutingStaleError(RuntimeError):
    """A replica refused a write because the signs' slots moved away
    under a newer routing epoch (the reshard freeze and cutover window).
    Retryable once the caller holds a table with ``epoch >= min_epoch``.
    Over RPC it is a plain ``RpcError`` whose message starts with
    :data:`STALE_PREFIX`; :func:`is_routing_stale` reads both forms."""

    def __init__(self, min_epoch: int, msg: str = ""):
        super().__init__(msg or f"{STALE_PREFIX}{min_epoch}")
        self.min_epoch = int(min_epoch)


def is_routing_stale(exc: BaseException) -> Optional[int]:
    """The minimum epoch a stale-routing failure demands, else None."""
    if isinstance(exc, RoutingStaleError):
        return exc.min_epoch
    msg = str(exc)
    at = msg.find(STALE_PREFIX)
    if at < 0:
        return None
    tail = msg[at + len(STALE_PREFIX):]
    digits = ""
    for ch in tail:
        if not ch.isdigit():
            break
        digits += ch
    return int(digits) if digits else None


class RoutingTable:
    """Immutable epoch-stamped slot→replica assignment (see module
    docstring for the routing function and the uniform-birth rule)."""

    __slots__ = ("epoch", "num_slots", "num_replicas", "replica_of_slot",
                 "weights", "_uniform")

    def __init__(self, epoch: int, replica_of_slot: np.ndarray,
                 num_replicas: int,
                 weights: Optional[np.ndarray] = None):
        self.epoch = int(epoch)
        a = np.ascontiguousarray(replica_of_slot, dtype=np.int32)
        a.setflags(write=False)
        self.replica_of_slot = a
        self.num_slots = len(a)
        self.num_replicas = int(num_replicas)
        if self.num_slots <= 0:
            raise ValueError("routing table needs at least one slot")
        if self.num_replicas <= 0:
            raise ValueError("routing table needs at least one replica")
        if len(a) and (a.min() < 0 or a.max() >= self.num_replicas):
            raise ValueError(
                f"slot assignment references replica outside "
                f"[0, {self.num_replicas})")
        if weights is not None:
            weights = np.ascontiguousarray(weights, dtype=np.float64)
            if len(weights) != self.num_slots:
                raise ValueError("per-slot weights length != num_slots")
            weights.setflags(write=False)
        self.weights = weights
        # cached: does this table route EXACTLY like hash % R? That is
        # the capability gate for the native shard_order fast path and
        # the byte-identical-wire guarantee.
        self._uniform = bool(
            self.num_slots % self.num_replicas == 0
            and np.array_equal(
                a, np.arange(self.num_slots, dtype=np.int32)
                % np.int32(self.num_replicas)))

    # --- construction ----------------------------------------------------

    @classmethod
    def uniform(cls, num_replicas: int,
                slots_per_replica: Optional[int] = None,
                epoch: int = 1) -> "RoutingTable":
        """The launch-default table: ``R * slots_per_replica`` slots
        (default ``PERSIA_ROUTING_SLOTS_PER_REPLICA``), slot s → s % R —
        bit-exact ``farmhash % R`` routing."""
        spr = int(slots_per_replica if slots_per_replica is not None
                  else knobs.get("PERSIA_ROUTING_SLOTS_PER_REPLICA"))
        if spr <= 0:
            raise ValueError("slots_per_replica must be positive")
        n = num_replicas * spr
        return cls(epoch,
                   np.arange(n, dtype=np.int32) % np.int32(num_replicas),
                   num_replicas)

    def derive(self, replica_of_slot: Sequence[int], num_replicas: int,
               weights: Optional[np.ndarray] = None) -> "RoutingTable":
        """The successor table over the same slot space at ``epoch + 1``
        (the reshard cutover's constructor)."""
        a = np.ascontiguousarray(replica_of_slot, dtype=np.int32)
        if len(a) != self.num_slots:
            raise ValueError(
                f"derived table changes the slot space "
                f"({self.num_slots} -> {len(a)}); slots are the "
                f"migration unit and must be preserved")
        return RoutingTable(self.epoch + 1, a, num_replicas,
                            weights=weights)

    # --- routing ---------------------------------------------------------

    @property
    def is_uniform_modulo(self) -> bool:
        """True when this table routes exactly like ``hash % R`` — the
        native ``mw_native.shard_order`` kernel (which hard-codes the
        modulo) may serve it, and the wire is byte-identical to the
        pre-routing stack."""
        return self._uniform

    def slot_of(self, signs: np.ndarray) -> np.ndarray:
        """Slot index per sign: farmhash64(sign) % num_slots."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        return (farmhash64_np(signs)
                % np.uint64(self.num_slots)).astype(np.int64)

    def replica_of(self, signs: np.ndarray) -> np.ndarray:
        """Owning replica per sign (int64, shaped like ``signs``)."""
        return self.replica_of_slot[self.slot_of(signs)].astype(np.int64)

    def slots_of_replica(self, replica: int) -> np.ndarray:
        """The slots a replica owns (ascending)."""
        return np.nonzero(self.replica_of_slot
                          == np.int32(replica))[0].astype(np.int64)

    def moves_to(self, other: "RoutingTable") -> List[Dict]:
        """The migration plan from this table to ``other``: one
        ``{"donor", "target", "slots"}`` entry per (donor, target) pair
        with at least one reassigned slot, in (donor, target) order."""
        if other.num_slots != self.num_slots:
            raise ValueError("tables span different slot spaces")
        moved = np.nonzero(self.replica_of_slot
                           != other.replica_of_slot)[0]
        pairs: Dict[tuple, List[int]] = {}
        for s in moved.tolist():
            key = (int(self.replica_of_slot[s]),
                   int(other.replica_of_slot[s]))
            pairs.setdefault(key, []).append(int(s))
        return [{"donor": d, "target": t, "slots": slots}
                for (d, t), slots in sorted(pairs.items())]

    # --- serialization ---------------------------------------------------

    def to_doc(self) -> Dict:
        doc = {
            "v": TABLE_VERSION,
            "epoch": self.epoch,
            "num_slots": self.num_slots,
            "num_replicas": self.num_replicas,
            "replica_of_slot": self.replica_of_slot.tolist(),
        }
        if self.weights is not None:
            doc["weights"] = [round(float(w), 9) for w in self.weights]
        return doc

    def to_bytes(self) -> bytes:
        """The canonical wire form (sorted keys, no whitespace): what the
        coordinator KV stores."""
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_doc(cls, doc: Dict) -> "RoutingTable":
        if int(doc.get("v", 0)) != TABLE_VERSION:
            raise ValueError(
                f"unsupported routing table version {doc.get('v')!r}")
        weights = doc.get("weights")
        return cls(doc["epoch"],
                   np.asarray(doc["replica_of_slot"], dtype=np.int32),
                   doc["num_replicas"],
                   weights=(np.asarray(weights, dtype=np.float64)
                            if weights is not None else None))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "RoutingTable":
        return cls.from_doc(json.loads(raw.decode("utf-8")))

    def __repr__(self):
        kind = "uniform" if self._uniform else "custom"
        return (f"RoutingTable(epoch={self.epoch}, slots={self.num_slots},"
                f" replicas={self.num_replicas}, {kind})")

    def __eq__(self, other):
        return (isinstance(other, RoutingTable)
                and self.epoch == other.epoch
                and self.num_replicas == other.num_replicas
                and np.array_equal(self.replica_of_slot,
                                   other.replica_of_slot))

    def __hash__(self):  # tables are value objects; keep dict-usable
        return hash((self.epoch, self.num_slots, self.num_replicas))


class RoutingHolder:
    """The current table and, while a double-read window is open, its
    predecessor. Mutation is epoch-checked under a lock; readers take a
    plain reference (a table is immutable, so a reader is always
    consistent)."""

    def __init__(self, table: RoutingTable):
        self._lock = threading.Lock()
        self._table = table
        self._prev: Optional[RoutingTable] = None
        self._prev_expiry = 0.0

    @property
    def table(self) -> RoutingTable:
        return self._table  # atomic reference read

    @property
    def prev(self) -> Optional[RoutingTable]:
        """The pre-swap table while the double-read window is open (None
        once drained). The window closes by itself after twice
        ``PERSIA_RESHARD_DRAIN_SEC``: a consumer that pulls its tables
        from the coordinator is in no controller's finalize list, and
        would otherwise read moved rows from the donors for ever."""
        prev = self._prev
        if prev is not None and _time.monotonic() >= self._prev_expiry:
            self.close_window()
            return None
        return prev

    @property
    def epoch(self) -> int:
        return self._table.epoch

    def apply(self, table: RoutingTable) -> bool:
        """Install a newer table; False (nothing changes) when the epoch
        does not advance, so duplicate and reordered publishes are
        harmless."""
        with self._lock:
            if table.epoch <= self._table.epoch:
                return False
            self._prev = self._table
            self._prev_expiry = _time.monotonic() + 2.0 * float(
                knobs.get("PERSIA_RESHARD_DRAIN_SEC"))
            self._table = table
            return True

    def window(self):
        """``(table, prev)`` read together under the lock, so a concurrent
        :meth:`apply` never hands out a torn pair. The same self-expiry
        as :attr:`prev`."""
        with self._lock:
            prev = self._prev
            if prev is not None and _time.monotonic() >= self._prev_expiry:
                self._prev = None
                prev = None
            return self._table, prev

    def close_window(self):
        """Drop the double-read predecessor (the migration drained)."""
        with self._lock:
            self._prev = None


def publish_to_coordinator(coordinator_client, table: RoutingTable):
    """Publish a table through the coordinator KV. A publisher whose
    epoch is not newer than the KV's (a resumed controller whose
    journal a newer migration superseded) writes nothing: pull-side
    consumers would otherwise route writes to replicas that no longer
    own them."""
    raw = coordinator_client.kv_get(COORDINATOR_KEY)
    if raw:
        current = RoutingTable.from_bytes(raw)
        if current.epoch >= table.epoch:
            if current.epoch > table.epoch:
                _logger.warning(
                    "refusing to publish routing epoch %d over the "
                    "coordinator's newer epoch %d", table.epoch,
                    current.epoch)
            return
    coordinator_client.kv_put(COORDINATOR_KEY, table.to_bytes())


def fetch_from_coordinator(coordinator_client) -> Optional[RoutingTable]:
    raw = coordinator_client.kv_get(COORDINATOR_KEY)
    return RoutingTable.from_bytes(raw) if raw else None
