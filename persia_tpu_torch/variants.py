"""Multi-model variant registry: one PS fleet, N dense models
(``persia_tpu/variants.py``).

A production recommender rarely serves ONE model: an A/B experiment
runs several dense-model versions (candidate rankers, exploration
arms, a rollback-safe previous release) over the SAME embedding
fleet — the sparse tier is the expensive, stateful part, and every
variant shares it. This module is the control-plane half of that
layer: a thread-safe registry of named variants with

- a **default** variant (the one plain ``predict`` serves — the
  pre-variant wire stays byte-identical when nothing else registers),
- a **deterministic weighted split**: a request carrying a route key
  lands on the same variant on every serving replica, because the
  split is a pure function of ``(key, live weights)`` — no RNG, no
  per-replica state, so per-variant request counts are exactly
  reproducible (bench.py --mode online pins them),
- per-variant **status** (``live`` | ``draining``): a draining
  variant takes no new split traffic but still answers explicit
  requests (pinned sessions finish), which is what a safe rollback
  needs, and
- promote/remove/weight mutations that the serving tier exposes over
  its ``variant_admin`` RPC.

The data-plane half (one :class:`~persia_tpu_torch.ctx.InferCtx` per
variant, per-variant metrics) lives in :mod:`persia_tpu_torch.serving`.
"""

import hashlib
import threading
import time
from typing import Dict, List, Optional

from persia_tpu_torch import knobs

STATUS_LIVE = "live"
STATUS_DRAINING = "draining"


def route_bucket(key: bytes, buckets: Optional[int] = None) -> int:
    """Deterministic bucket of a route key in ``[0, buckets)``.

    blake2b (stdlib, stable across processes and platforms) rather than
    the sign farmhash: route keys are arbitrary bytes (user ids, header
    values), not uint64 signs, and the variant split must agree across
    every serving replica AND the bench's client-side expectation."""
    n = int(buckets if buckets is not None
            else knobs.get("PERSIA_VARIANT_SPLIT_BUCKETS"))
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(digest, "big") % n


class VariantInfo:
    """One registered variant (registry-internal; ``describe()`` is the
    JSON-safe view)."""

    __slots__ = ("name", "weight", "status", "meta", "created_t")

    def __init__(self, name: str, weight: float = 0.0,
                 meta: Optional[Dict] = None):
        self.name = name
        self.weight = float(weight)
        self.status = STATUS_LIVE
        self.meta = dict(meta or {})
        self.created_t = time.time()

    def describe(self) -> Dict:
        return {"name": self.name, "weight": self.weight,
                "status": self.status, "meta": dict(self.meta),
                "created_t": round(self.created_t, 3)}


class VariantRegistry:
    """Named variants + the deterministic weighted router.

    Concurrency: mutations and the route snapshot both run under one
    lock; :meth:`route` reads a consistent (names, weights) snapshot,
    then computes the split without the lock. Routing is stable under
    concurrent admin mutations in the sense that every request sees
    some complete registry state, never a half-applied one.
    """

    def __init__(self, default: Optional[str] = None):
        self._lock = threading.Lock()
        self._variants: Dict[str, VariantInfo] = {}
        self._default: Optional[str] = None
        if default is not None:
            self.add(default, weight=1.0, default=True)

    # --- mutations -------------------------------------------------------

    def add(self, name: str, weight: float = 0.0,
            default: bool = False, meta: Optional[Dict] = None,
            ) -> VariantInfo:
        if not name:
            raise ValueError("variant needs a non-empty name")
        info = VariantInfo(name, weight=weight, meta=meta)
        with self._lock:
            if name in self._variants:
                raise ValueError(f"variant {name!r} already registered")
            self._variants[name] = info
            if default or self._default is None:
                self._default = name
        return info

    def remove(self, name: str):
        """Delete a variant. The default is protected — promote another
        variant first (a registry must always have an answer for a
        plain ``predict``)."""
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"variant {name!r} is not registered")
            if name == self._default:
                raise ValueError(
                    f"variant {name!r} is the default; promote another "
                    "variant before removing it")
            del self._variants[name]

    def promote(self, name: str):
        """Make ``name`` the default (the promote-a-canary /
        rollback-to-previous operation). Also returns it to ``live``:
        a rolled-back-to variant must take traffic again."""
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"variant {name!r} is not registered")
            self._default = name
            self._variants[name].status = STATUS_LIVE

    def set_weight(self, name: str, weight: float):
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"variant {name!r} is not registered")
            self._variants[name].weight = float(weight)

    def reweight(self, weights: Dict[str, float]):
        """Atomic bulk weight update: either every named variant gets
        its new weight or nothing changes. The autopilot's traffic-
        shift action uses this — shedding a burning variant means
        lowering ITS weight while raising another's, and two
        set_weight calls would expose a half-shifted split to every
        route() between them."""
        with self._lock:
            missing = [n for n in weights if n not in self._variants]
            if missing:
                raise KeyError(
                    f"variants {missing!r} are not registered")
            bad = [n for n, w in weights.items() if float(w) < 0]
            if bad:
                raise ValueError(
                    f"negative weights for {bad!r}")
            for n, w in weights.items():
                self._variants[n].weight = float(w)

    def set_status(self, name: str, status: str):
        if status not in (STATUS_LIVE, STATUS_DRAINING):
            raise ValueError(f"bad variant status {status!r}")
        with self._lock:
            if name not in self._variants:
                raise KeyError(f"variant {name!r} is not registered")
            self._variants[name].status = status

    # --- reads -----------------------------------------------------------

    @property
    def default(self) -> Optional[str]:
        return self._default  # atomic reference read

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._variants)

    def get(self, name: str) -> VariantInfo:
        with self._lock:
            info = self._variants.get(name)
        if info is None:
            raise KeyError(f"variant {name!r} is not registered")
        return info

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._variants

    def __len__(self) -> int:
        with self._lock:
            return len(self._variants)

    def describe(self) -> List[Dict]:
        with self._lock:
            default = self._default
            infos = [v.describe() for v in self._variants.values()]
        for d in infos:
            d["default"] = d["name"] == default
        return sorted(infos, key=lambda d: d["name"])

    # --- routing ---------------------------------------------------------

    def _split_snapshot(self) -> List[VariantInfo]:
        """The weighted-split candidate pool: live variants with
        positive weight, in NAME order — the order is part of the
        split function, so it must be deterministic across replicas
        (insertion order is not)."""
        with self._lock:
            pool = [v for v in self._variants.values()
                    if v.status == STATUS_LIVE and v.weight > 0]
        return sorted(pool, key=lambda v: v.name)

    def route(self, key: Optional[bytes] = None,
              explicit: Optional[str] = None) -> str:
        """Resolve one request to a variant name.

        Precedence: an ``explicit`` header pin wins (draining variants
        still answer — pinned sessions must finish); otherwise a route
        ``key`` lands in the weighted split over live positive-weight
        variants; otherwise (no key, or an empty pool) the default
        serves. Raises ``KeyError`` for an explicit unknown variant —
        the serving tier surfaces that as a request error rather than
        silently mis-routing an experiment."""
        if explicit is not None:
            if explicit not in self:
                raise KeyError(f"variant {explicit!r} is not registered")
            return explicit
        default = self._default
        if default is None:
            raise KeyError("no variants registered")
        if key is None:
            return default
        pool = self._split_snapshot()
        if len(pool) <= 1:
            return pool[0].name if pool else default
        buckets = int(knobs.get("PERSIA_VARIANT_SPLIT_BUCKETS"))
        bucket = route_bucket(key, buckets)
        total = sum(v.weight for v in pool)
        cum = 0.0
        for v in pool:
            cum += v.weight
            # strict <: variant i owns buckets [cum_{i-1}, cum_i)
            if bucket < cum / total * buckets:
                return v.name
        return pool[-1].name  # float-rounding tail

    def expected_split(self, keys) -> Dict[str, int]:
        """Exact per-variant request counts :meth:`route` will produce
        for ``keys`` under the CURRENT pool — the bench/test oracle
        that pins metrics isolation (pure function of the same
        snapshot, so counts match to the request)."""
        out: Dict[str, int] = {}
        for k in keys:
            name = self.route(key=k)
            out[name] = out.get(name, 0) + 1
        return out
