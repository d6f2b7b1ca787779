"""Versioned slot-based sign routing (``persia_tpu/routing.py``), the
value object only.

A :class:`RoutingTable` is an epoch-stamped slot -> replica map over a
fixed slot space::

    slot(sign)    = farmhash64(sign) % num_slots
    replica(sign) = replica_of_slot[slot(sign)]

A table born uniform has ``num_slots = num_replicas * SLOTS_PER_REPLICA``,
so ``slot % num_replicas`` reproduces ``farmhash64(sign) % num_replicas``
bit-exactly. The checkpoint's resharding load reads a dump's table from
its done marker for the ownership filter. The live routing of the worker
(``RoutingHolder`` epochs, the reshard controller) is not ported.
"""

from typing import Dict, Optional

import numpy as np

from persia_tpu_torch.hashing import farmhash64_np

TABLE_VERSION = 1
# the JAX package's default slot count per replica of a uniform table
# (its ``PERSIA_ROUTING_SLOTS_PER_REPLICA``); the port builds uniform
# tables only, which route like ``farmhash64 % R`` whatever this is
SLOTS_PER_REPLICA = 64


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
    def uniform(cls, num_replicas: int, epoch: int = 1) -> "RoutingTable":
        """The launch-default table: ``R * SLOTS_PER_REPLICA`` slots,
        slot s → s % R — bit-exact ``farmhash % R`` routing."""
        n = num_replicas * SLOTS_PER_REPLICA
        return cls(epoch,
                   np.arange(n, dtype=np.int32) % np.int32(num_replicas),
                   num_replicas)

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

    def __eq__(self, other):
        return (isinstance(other, RoutingTable)
                and self.epoch == other.epoch
                and self.num_replicas == other.num_replicas
                and np.array_equal(self.replica_of_slot,
                                   other.replica_of_slot))

    def __hash__(self):  # tables are value objects; keep dict-usable
        return hash((self.epoch, self.num_slots, self.num_replicas))
