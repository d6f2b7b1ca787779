"""Workload hotness telemetry: bounded-memory, mergeable per-table
access sketches over the embedding lookup stream
(``persia_tpu/hotness.py``, the tracker half).

Three streaming summaries, composed per (table, internal shard):

- **Space-Saving** (Metwally et al. '05) keeps the top-K heavy hitters
  with per-item count and error bound: ``count - err <= true <= count``;
- **Count-Min** (Cormode & Muthukrishnan '05) answers a frequency upper
  bound for any sign and doubles as the admission filter that keeps the
  Space-Saving update off the hot path for provably-cold signs;
- **HyperLogLog** estimates the distinct-row count.

All three are mergeable: :func:`merge_snapshots` adds CM cells and
Space-Saving counts and takes the max of HLL registers, exactly
commutative and associative.

Lock discipline: :class:`HotnessTracker` owns one lock per internal shard
and is the only writer of its cells; holders call
:meth:`HotnessTracker.observe` outside their own shard locks, so the
tracker's locks are leaves.

The report the observability sidecar serves at ``/hotness``
(:func:`summary_view`: per-table totals, the fitted zipf skew, the
coverage curve and the hottest rows), and the planner half that feeds
the control plane: the device cache's HBM plan (:func:`planner_report`),
per-routing-slot traffic weights (:func:`slot_weights`), the
hotness-balanced placement the reshard controller executes
(:func:`placement_plan`) and the ``/fleet/hotness`` document
(:func:`fleet_report`).
"""

import base64
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.hashing import farmhash64_np
from persia_tpu_torch.ps.rng import internal_shard_of
from persia_tpu_torch.worker.monitor import HyperLogLog

SNAPSHOT_VERSION = 1
# the coverage curve's "top p% of rows" grid
DEFAULT_COVERAGE_FRACS = (0.0001, 0.0005, 0.001, 0.002, 0.005, 0.01,
                          0.02, 0.05, 0.1, 0.2, 0.5, 1.0)


class SpaceSaving:
    """Space-Saving heavy-hitter summary of at most ``k`` items,
    array-backed and batch-updated.

    The summary lives in three aligned numpy arrays (signs sorted
    ascending, counts, inherited errors), so one lookup batch costs a
    handful of vectorized ops instead of per-item heap work — the
    difference between telemetry that fits a 3% cycle budget and
    telemetry that doesn't. Admissions at capacity evict the batch's
    worth of current minima in one ``argpartition``; each admitted
    sign inherits one evicted count as its error, largest newcomer
    paired with smallest evictee. That batched eviction is the one
    deviation from the sequential textbook algorithm (which re-reads
    the min after every eviction), and it preserves both invariants
    the property tests pin: ``count >= true`` (a newcomer's unseen
    prior occurrences are <= the summary min <= every evicted count)
    and ``count - err <= true``.

    Not thread-safe on purpose: one instance lives under one shard
    lock of :class:`HotnessTracker` (or in single-threaded test code).
    """

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._signs = np.empty(0, dtype=np.uint64)
        self._counts = np.empty(0, dtype=np.float64)  # integer-valued
        self._errs = np.empty(0, dtype=np.float64)

    def __len__(self) -> int:
        return len(self._signs)

    def min_count(self) -> int:
        """The smallest tracked count (0 while below capacity)."""
        if len(self._signs) < self.k:
            return 0
        return int(self._counts.min())

    def offer(self, sign: int, inc: int = 1):
        """One item: the sequential algorithm (a batch of one)."""
        self.offer_many(np.array([sign], dtype=np.uint64),
                        np.array([inc], dtype=np.float64))

    def count_of(self, sign: int) -> int:
        """The tracked count of one sign (0 when untracked)."""
        return int(self.counts_of(np.array([sign], dtype=np.uint64))[0])

    @property
    def counts(self) -> Dict[int, int]:
        """sign -> tracked count, as a dict (small summaries)."""
        return {int(s): int(c) for s, c in zip(self._signs, self._counts)}

    def counts_of(self, signs: np.ndarray) -> np.ndarray:
        """Tracked count of each sign (0 for untracked signs), int64: the
        hotness-admitted device-cache mapper queries its whole victim
        queue once a batch."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.zeros(len(signs), dtype=np.int64)
        if len(signs) == 0:
            return out
        mask, pos = self.member_mask(signs)
        if mask.any():
            out[mask] = self._counts[pos[mask]].astype(np.int64)
        return out

    def decay(self, factor: float = 0.5):
        """Age every tracked count and its error bound by ``factor``
        (floored), W-TinyLFU's periodic halving: a formerly hot row's
        lifetime count cannot block newly hot rows forever. The device
        cache's admission only; the telemetry trackers never decay (their
        merge needs raw additive counts)."""
        np.floor(self._counts * factor, out=self._counts)
        np.floor(self._errs * factor, out=self._errs)

    def member_mask(self, signs: np.ndarray) -> np.ndarray:
        """Vectorized membership test against the sorted sign array.
        Returns (mask, positions-into-the-summary)."""
        if len(self._signs) == 0:
            return (np.zeros(len(signs), dtype=bool),
                    np.zeros(len(signs), dtype=np.int64))
        pos = np.searchsorted(self._signs, signs).clip(
            max=len(self._signs) - 1)
        return self._signs[pos] == signs, pos

    def offer_many(self, signs: np.ndarray, counts: np.ndarray,
                   estimates: Optional[np.ndarray] = None):
        """Batch offer of DISTINCT signs with the Count-Min admission
        filter: when the summary is full, an untracked sign is worth
        admission work only if its CM frequency upper bound reaches
        the current minimum (below it, the sequential algorithm would
        admit and immediately lose it to the next cold sign — skipping
        it only forgoes churn). Tracked members always take their
        increments."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        counts = np.asarray(counts, dtype=np.float64)
        member, pos = self.member_mask(signs)
        if member.any():
            # distinct signs -> distinct positions, plain fancy add
            self._counts[pos[member]] += counts[member]
        new_s, new_c = signs[~member], counts[~member]
        if len(new_s) == 0:
            return
        if estimates is not None and len(self._signs) >= self.k:
            keep = estimates[~member] >= self._counts.min()
            new_s, new_c = new_s[keep], new_c[keep]
            if len(new_s) == 0:
                return
        # largest newcomers first: the order a zipfian batch's hot
        # signs would reach a sequential summary in anyway, and it
        # keeps a flood of cold singletons from inflating the errors
        # the hot admissions inherit
        order = np.argsort(new_c, kind="stable")[::-1]
        new_s, new_c = new_s[order], new_c[order]
        room = self.k - len(self._signs)
        if room > 0:
            take = min(room, len(new_s))
            self._signs = np.concatenate([self._signs, new_s[:take]])
            self._counts = np.concatenate([self._counts, new_c[:take]])
            self._errs = np.concatenate([self._errs, np.zeros(take)])
            new_s, new_c = new_s[take:], new_c[take:]
        if len(new_s):
            # at capacity: textbook sequential admissions (each evicts
            # the CURRENT minimum and inherits it as error), driven by
            # a per-batch heap of (count, slot). Entries go stale when
            # their slot's count moves on; a stale top is discarded on
            # sight. Only filter-passing newcomers reach this loop, so
            # steady-state cold traffic never pays it.
            import heapq

            counts = self._counts
            heap = [(c, i) for i, c in enumerate(counts.tolist())]
            heapq.heapify(heap)
            for s, c in zip(new_s.tolist(), new_c.tolist()):
                while counts[heap[0][1]] != heap[0][0]:
                    heapq.heappop(heap)
                mc, slot = heapq.heappop(heap)
                self._signs[slot] = s
                counts[slot] = mc + c
                self._errs[slot] = mc
                heapq.heappush(heap, (mc + c, slot))
        self._resort()

    def _resort(self):
        order = np.argsort(self._signs, kind="stable")
        self._signs = self._signs[order]
        self._counts = self._counts[order]
        self._errs = self._errs[order]

    def snapshot(self) -> Dict[int, Tuple[int, int]]:
        return {int(s): (int(c), int(e)) for s, c, e in
                zip(self._signs, self._counts, self._errs)}


class CountMinSketch:
    """Count-Min over pre-hashed uint64 keys.

    ``depth`` rows of ``width`` cells; row i's index is the classic
    double-hash ``(h + i * h2) % width`` with ``h2`` odd, derived from
    the one FarmHash64 the caller already computed. Cells are float64
    holding integer values (exact to 2**53 — far beyond any lookup
    count this stores), so a batch update is one ``bincount`` per row
    and merged sketches stay exactly associative."""

    def __init__(self, width: int, depth: int):
        if width <= 0 or depth <= 0:
            raise ValueError("width and depth must be positive")
        self.width = width
        self.depth = depth
        self.rows = np.zeros((depth, width), dtype=np.float64)

    def _indices(self, hashes: np.ndarray) -> np.ndarray:
        """(depth, n) row indices in one broadcast (one errstate, one
        astype — the per-row version's fixed costs dominated the
        lookup path)."""
        h = hashes.astype(np.uint64, copy=False)
        h2 = (h >> np.uint64(32)) | np.uint64(1)
        d = np.arange(self.depth, dtype=np.uint64)[:, None]
        with np.errstate(over="ignore"):
            return ((h[None, :] + d * h2[None, :])
                    % np.uint64(self.width)).astype(np.int64)

    def add(self, hashes: np.ndarray, counts: np.ndarray):
        self.add_and_estimate(hashes, counts)

    def add_and_estimate(self, hashes: np.ndarray,
                         counts: np.ndarray) -> np.ndarray:
        """One pass: fold the batch in and return each hash's
        post-update frequency upper bound (hashed once — the admission
        filter wants the estimate right after the add anyway).
        bincount + row add beats np.add.at by an order of magnitude:
        ufunc.at pays per-element interpreter cost, the bincount pass
        and the full-width add are single C loops."""
        w = np.asarray(counts, dtype=np.float64)
        idx = self._indices(hashes)
        est = None
        for i in range(self.depth):
            self.rows[i] += np.bincount(idx[i], weights=w,
                                        minlength=self.width)
            row_est = self.rows[i][idx[i]]
            if est is None:
                est = row_est
            else:
                np.minimum(est, row_est, out=est)
        return est

    def estimate(self, hashes: np.ndarray) -> np.ndarray:
        """Each hash's frequency upper bound (the min over the rows)."""
        idx = self._indices(hashes)
        est = self.rows[0][idx[0]]
        for i in range(1, self.depth):
            np.minimum(est, self.rows[i][idx[i]], out=est)
        return est


class _TableGlobal:
    """One table's whole-replica sketches (count-min + HLL + total).
    Frequency estimation and distinct counting don't care about the
    shard split — one vectorized pass over the flush batch beats
    num_shards small ones by the fixed numpy per-call costs — so these
    live at table level under the tracker's table lock, while the
    Space-Saving summaries stay per internal shard."""

    __slots__ = ("cm", "hll", "total")

    def __init__(self, cm_width: int, cm_depth: int, hll_p: int):
        self.cm = CountMinSketch(cm_width, cm_depth)
        self.hll = HyperLogLog(hll_p)
        self.total = 0

    def fold_locked(self, counts: np.ndarray,
                    hashes: np.ndarray) -> np.ndarray:
        self.total += int(counts.sum())
        est = self.cm.add_and_estimate(hashes, counts)
        self.hll.add_hashed(hashes)
        return est


class HotnessTracker:
    """Per-internal-shard hotness cells behind one lock per shard,
    fed through a small per-table staging buffer.

    The holder calls :meth:`observe` once per lookup batch, outside
    its own shard locks. The batch is *staged* (one array append under
    the buffer lock — a memcpy, no sketch math) and the sketches are
    folded in once ~``FLUSH_SIGNS`` signs accumulate: that amortizes
    the fixed numpy per-call costs across several batches AND dedups
    across them before any per-shard work (zipfian traffic repeats
    its hot signs batch to batch). At flush, signs are deduped and
    hashed once (vectorized), then bucketed by the same
    ``internal_shard_of`` hash the store uses, so each shard's cell is
    touched by exactly the traffic that shard serves and a
    per-replica snapshot is a disjoint union. :meth:`snapshot`
    flushes first, so readers never see the staging lag."""

    FLUSH_SIGNS = 65_536

    def __init__(self, num_shards: int, topk: Optional[int] = None,
                 cm_width: Optional[int] = None,
                 cm_depth: Optional[int] = None, hll_p: int = 12):
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self.num_shards = num_shards
        self.topk = int(topk if topk is not None
                        else knobs.get("PERSIA_HOTNESS_TOPK"))
        self.cm_width = int(cm_width if cm_width is not None
                            else knobs.get("PERSIA_HOTNESS_CM_WIDTH"))
        self.cm_depth = int(cm_depth if cm_depth is not None
                            else knobs.get("PERSIA_HOTNESS_CM_DEPTH"))
        self.hll_p = hll_p
        self._locks = [threading.Lock() for _ in range(num_shards)]
        # shard index -> {table(dim) -> SpaceSaving}
        self._cells: List[Dict[int, SpaceSaving]] = [
            {} for _ in range(num_shards)]
        # table(dim) -> _TableGlobal (cm + hll + total), own leaf lock
        self._table_lock = threading.Lock()
        self._tables: Dict[int, _TableGlobal] = {}
        # table -> list of staged sign arrays (buffer lock only guards
        # the staging lists; sketch math runs under the sketch locks)
        self._buf_lock = threading.Lock()
        self._buf: Dict[int, List[np.ndarray]] = {}
        self._buf_n: Dict[int, int] = {}

    def _cell_locked(self, shard: int, table: int) -> SpaceSaving:
        cell = self._cells[shard].get(table)
        if cell is None:
            cell = self._cells[shard][table] = SpaceSaving(self.topk)
        return cell

    def observe(self, table: int, signs: np.ndarray):
        """Record one lookup batch against ``table`` (the slot dim —
        the per-dim grouping the whole PS wire already routes by)."""
        if len(signs) == 0:
            return
        table = int(table)
        staged = None
        with self._buf_lock:
            self._buf.setdefault(table, []).append(
                np.ascontiguousarray(signs, dtype=np.uint64))
            n = self._buf_n[table] = self._buf_n.get(table, 0) + len(signs)
            if n >= self.FLUSH_SIGNS:
                staged = self._buf.pop(table)
                self._buf_n[table] = 0
        if staged is not None:
            self._fold(table, np.concatenate(staged))

    def _fold(self, table: int, signs: np.ndarray):
        """Dedup + hash once, fold the table-level CM/HLL in one
        vectorized pass (its estimate doubles as the Space-Saving
        admission filter), then update each touched shard's summary
        under that shard's lock. All locks here are leaves — no
        nesting, no ordering hazard."""
        uniq, counts = np.unique(signs, return_counts=True)
        hashes = farmhash64_np(uniq)
        with self._table_lock:
            g = self._tables.get(table)
            if g is None:
                g = self._tables[table] = _TableGlobal(
                    self.cm_width, self.cm_depth, self.hll_p)
            est = g.fold_locked(counts, hashes)
        shard_ids = internal_shard_of(uniq, self.num_shards)
        for shard in np.unique(shard_ids):
            sel = np.nonzero(shard_ids == shard)[0]
            with self._locks[shard]:
                self._cell_locked(int(shard), table).offer_many(
                    uniq[sel], counts[sel], est[sel])

    def flush(self):
        """Fold every staged batch in (snapshot readers and tests call
        this; the hot path flushes on its own cadence)."""
        with self._buf_lock:
            staged = [(t, arrs) for t, arrs in self._buf.items() if arrs]
            self._buf = {}
            self._buf_n = {}
        for table, arrs in staged:
            self._fold(table, np.concatenate(arrs))

    def snapshot(self) -> Dict:
        """Serializable roll-up: per-table CM/HLL/total read under the
        table lock, every shard's summary under its lock (shards
        partition the sign space, so the top-K union is disjoint).
        Like the holder's resident-bytes counters, the cross-lock
        union is a consistent-enough cut for telemetry, not a
        transactional one."""
        self.flush()
        agg: Dict[int, Dict] = {}
        with self._table_lock:
            for table, g in self._tables.items():
                agg[table] = {
                    "total": g.total,
                    "topk": {},
                    "cm": g.cm.rows.copy(),
                    "hll": g.hll.registers.copy(),
                    "unique_est": float(g.hll.estimate()),
                }
        for shard in range(self.num_shards):
            with self._locks[shard]:
                for table, cell in self._cells[shard].items():
                    a = agg.get(table)
                    if a is None:
                        continue  # racing first fold; next snapshot
                    for s, (c, e) in cell.snapshot().items():
                        oc, oe = a["topk"].get(s, (0, 0))
                        a["topk"][s] = (oc + c, oe + e)
        tables = {}
        for table, a in agg.items():
            tables[str(table)] = {
                "total": a["total"],
                "unique_est": a["unique_est"],
                "topk": sorted(
                    ([int(s), int(c), int(e)]
                     for s, (c, e) in a["topk"].items()),
                    key=lambda t: (-t[1], t[0])),
                "cm": _b64(a["cm"].tobytes()),
                "hll": _b64(a["hll"].tobytes()),
            }
        return {
            "enabled": True,
            "v": SNAPSHOT_VERSION,
            "k": self.topk,
            "num_shards": self.num_shards,
            "cm_width": self.cm_width,
            "cm_depth": self.cm_depth,
            "hll_p": self.hll_p,
            "total": sum(t["total"] for t in tables.values()),
            "tables": tables,
        }


def make_tracker(num_shards: int,
                 enabled: Optional[bool] = None) -> Optional[HotnessTracker]:
    """The one holder-side construction convention: ``None`` consults
    the ``PERSIA_HOTNESS`` knob at call time; disabled returns None so
    the lookup path's guard is a plain ``is not None``."""
    if enabled is None:
        enabled = knobs.get("PERSIA_HOTNESS")
    return HotnessTracker(num_shards) if enabled else None


def disabled_snapshot() -> Dict:
    return {"enabled": False, "v": SNAPSHOT_VERSION, "total": 0,
            "tables": {}}


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode("ascii")


def _unb64(s) -> bytes:
    return base64.b64decode(s)


# --- merging ---------------------------------------------------------------


def merge_snapshots(snaps: Sequence[Dict]) -> Dict:
    """Merge any number of snapshots into one. Exactly commutative and
    associative: top-K entries are summed pointwise over the sign
    union (the render-time truncation happens in :func:`top_rows`, not
    here), CM cells add, HLL registers max, totals add. Disabled or
    empty snapshots contribute nothing; mixed sketch geometries raise
    (replicas of one fleet share one knob config)."""
    merged = disabled_snapshot()
    geom = None
    for snap in snaps:
        if not snap or not snap.get("enabled"):
            continue
        sg = (snap.get("k"), snap.get("cm_width"), snap.get("cm_depth"),
              snap.get("hll_p"))
        if geom is None:
            geom = sg
            merged.update({"enabled": True, "k": snap.get("k"),
                           "cm_width": snap.get("cm_width"),
                           "cm_depth": snap.get("cm_depth"),
                           "hll_p": snap.get("hll_p")})
        elif geom != sg:
            raise ValueError(
                f"cannot merge hotness snapshots of different sketch "
                f"geometry: {geom} vs {sg}")
        merged["total"] += int(snap.get("total", 0))
        for table, t in snap.get("tables", {}).items():
            m = merged["tables"].get(table)
            if m is None:
                merged["tables"][table] = {
                    "total": int(t["total"]),
                    "topk": [list(row) for row in t["topk"]],
                    "cm": t["cm"],
                    "hll": t["hll"],
                }
                if t.get("row_bytes"):
                    merged["tables"][table]["row_bytes"] = int(
                        t["row_bytes"])
                continue
            m["total"] += int(t["total"])
            if t.get("row_bytes"):
                # replicas of one fleet share one storage policy; a
                # mid-rollout mix keeps the WIDER row so budget math
                # stays conservative
                m["row_bytes"] = max(int(m.get("row_bytes") or 0),
                                     int(t["row_bytes"]))
            by_sign = {s: [c, e] for s, c, e in m["topk"]}
            for s, c, e in t["topk"]:
                cur = by_sign.get(s)
                if cur is None:
                    by_sign[s] = [c, e]
                else:
                    cur[0] += c
                    cur[1] += e
            m["topk"] = sorted(
                ([s, ce[0], ce[1]] for s, ce in by_sign.items()),
                key=lambda r: (-r[1], r[0]))
            a = np.frombuffer(_unb64(m["cm"]), dtype=np.float64)
            b = np.frombuffer(_unb64(t["cm"]), dtype=np.float64)
            m["cm"] = _b64((a + b).tobytes())
            ha = np.frombuffer(_unb64(m["hll"]), dtype=np.uint8)
            hb = np.frombuffer(_unb64(t["hll"]), dtype=np.uint8)
            m["hll"] = _b64(np.maximum(ha, hb).tobytes())
    # recompute per-table uniques from the merged HLLs (a sum of the
    # inputs' estimates would double-count signs seen by >1 replica)
    hll_p = merged.get("hll_p")
    if hll_p:
        for t in merged["tables"].values():
            hll = HyperLogLog(hll_p)
            hll.registers = np.frombuffer(
                _unb64(t["hll"]), dtype=np.uint8).copy()
            t["unique_est"] = float(hll.estimate())
    return merged


def top_rows(table_snap: Dict, n: int) -> List[List[int]]:
    """The ``n`` hottest ``[sign, count, err]`` rows of one table."""
    return table_snap["topk"][:n]


# --- the /hotness report: zipf fit, coverage ---------------------------


def fit_zipf_alpha(counts: Sequence[float],
                   skip_head: int = 8) -> Optional[float]:
    """Least-squares slope of log(count) vs log(rank) over the top-K
    counts (descending). The first few ranks are skipped: zipfian heads
    routinely deviate from the tail power law, and the tail slope is
    what extrapolation beyond K needs. Returns None when there is not
    enough signal to fit."""
    counts = [c for c in counts if c > 0]
    if len(counts) < max(skip_head + 8, 16):
        return None
    lo = max(1, skip_head)
    ranks = np.arange(lo, len(counts) + 1, dtype=np.float64)
    vals = np.asarray(counts[lo - 1:], dtype=np.float64)
    slope, _ = np.polyfit(np.log(ranks), np.log(vals), 1)
    alpha = -float(slope)
    return alpha if math.isfinite(alpha) and alpha > 0 else None


def _zipf_partial_sum(alpha: float, lo: float, hi: float) -> float:
    """Approximate sum of r^-alpha for r in (lo, hi] via the integral
    (the extrapolation tail only — head mass comes from real counts)."""
    if hi <= lo:
        return 0.0
    if abs(alpha - 1.0) < 1e-9:
        return math.log(hi / lo)
    return (hi ** (1.0 - alpha) - lo ** (1.0 - alpha)) / (1.0 - alpha)


def _tail_model(c_k: float, k: float, uniq: float, remaining: float):
    """Mass-conserving model of the untracked tail: counts decay as
    ``c_k * (r/k)^-a`` down to the floor of 1 (a finite sample's deep
    tail is singletons), with the decay ``a`` solved so the tail's
    total mass equals the ``remaining`` lookups the head did not
    cover. Anchoring on conservation instead of a fitted slope means
    coverage hits exactly 1.0 at the last unique row and a noisy
    log-log fit cannot claim mass the stream never had. Returns
    ``tail_mass(n)``: lookups covered by tail ranks (k, n]."""
    m_rows = max(uniq - k, 1.0)

    def uniform(n):
        return remaining * (min(n, uniq) - k) / m_rows

    if remaining <= m_rows or c_k <= 1.0:
        # averages below one count per row: sketch noise territory,
        # spread the mass evenly
        return uniform

    log_ck = math.log(c_k)

    def mass(a, upto=None):
        # r_star solves c_k * (r/k)^-a == 1; computed in log space so
        # a tiny decay exponent cannot overflow the power
        if log_ck / a > math.log(uniq / k):
            r_star = uniq
        else:
            r_star = min(k * math.exp(log_ck / a), uniq)
        hi = min(upto, uniq) if upto is not None else uniq
        power = c_k * (k ** a) * _zipf_partial_sum(a, k, min(hi, r_star))
        floor = max(hi - max(r_star, k), 0.0)
        return power + floor

    if mass(1e-6) <= remaining:
        # even a flat tail at c_k cannot carry the remaining mass
        # (head overcounting ate it) — degrade to uniform
        return uniform
    lo_a, hi_a = 1e-6, 64.0
    for _ in range(60):
        mid = (lo_a + hi_a) / 2.0
        if mass(mid) > remaining:
            lo_a = mid
        else:
            hi_a = mid
    a = (lo_a + hi_a) / 2.0
    scale = remaining / max(mass(a), 1e-12)  # close the bisection gap

    def tail(n):
        return scale * mass(a, upto=float(n))

    return tail


def _stable_counts(rows: Sequence) -> np.ndarray:
    """Bias-corrected count estimates from ``[sign, count, err]``
    summary rows, sorted descending. Space-Saving counts straddle the
    truth: ``count`` overestimates by up to ``err``, ``count - err``
    underestimates; the midpoint halves the systematic bias, but only
    for *stable* cells (count >= 2*err) — a cell dominated by the
    inherited eviction floor is churn, not signal, and keeping churned
    cells drags any statistic over the summary (coverage prefix sums,
    the log-log zipf slope) toward the flat eviction floor. When every
    cell is churning (a near-uniform stream), fall back to midpoints of
    everything rather than returning nothing."""
    stable = [c - e / 2.0 for _s, c, e in rows if c >= 2 * e]
    return np.sort(np.asarray(stable or
                              [c - e / 2.0 for _s, c, e in rows],
                              dtype=np.float64))[::-1]


def coverage_curve(table_snap: Dict,
                   fracs: Sequence[float] = DEFAULT_COVERAGE_FRACS
                   ) -> List[Dict]:
    """"Top p% of rows serve q% of lookups" points for one table.

    Ranks inside the top-K summary read straight off the (slightly
    over-counted) Space-Saving counts; ranks beyond K extrapolate the
    fitted zipf tail anchored at the summary's own tail counts, capped
    so coverage is monotone and <= 1."""
    total = float(table_snap.get("total") or 0)
    rows = table_snap.get("topk", ())
    uniq = max(float(table_snap.get("unique_est") or 0.0),
               float(len(rows)), 1.0)
    out = []
    if total <= 0 or not rows:
        return [{"frac": f, "rows": 0, "coverage": 0.0} for f in fracs]
    # Churned cells are dropped from the trusted head (_stable_counts)
    # and their mass handed to the conservation-anchored tail model
    # (measured worst coverage error on zipf(1.05): raw 3.4 pts,
    # midpoint-everywhere 0.6/2.2 pts stable/churning summary,
    # stability-cut 0.2/0.9), re-sorted since the correction reorders
    # mid-rank rows.
    counts = _stable_counts(rows)
    prefix = np.cumsum(counts, dtype=np.float64)
    k = len(counts)
    head = float(prefix[-1])
    remaining = max(total - head, 0.0)
    tail_mass = _tail_model(max(float(counts[-1]), 0.0), float(k), uniq,
                            remaining)
    for f in fracs:
        n = max(1, int(round(f * uniq)))
        n = min(n, int(uniq))
        if n <= k:
            # inside the summary: straight off the (slightly
            # over-counted) Space-Saving prefix sums
            cov = prefix[n - 1] / total
        else:
            # evaluate the tail at the fractional rank: int truncation
            # of `n` would undershoot the conserved mass at frac=1.0
            cov = (head + tail_mass(min(f * uniq, uniq))) / total
        out.append({"frac": f, "rows": n,
                    "coverage": round(min(max(cov, 0.0), 1.0), 6)})
    # enforce monotonicity across the grid (extrapolation joins the
    # exact prefix at rank K; tiny seams must not read as regressions)
    for i in range(1, len(out)):
        if out[i]["coverage"] < out[i - 1]["coverage"]:
            out[i]["coverage"] = out[i - 1]["coverage"]
    return out


def table_report(table_snap: Dict,
                 fracs: Sequence[float] = DEFAULT_COVERAGE_FRACS,
                 top_n: int = 16) -> Dict:
    """Human/SLO-facing summary of one table: totals, distinct
    estimate, fitted skew, coverage curve, hottest rows."""
    rows = table_snap.get("topk", ())
    # fit on the stability-cut corrected counts: raw Space-Saving
    # counts carry the eviction floor in every churned tail cell, which
    # flattens the log-log slope and reads genuinely skewed traffic
    # (alpha ~1.0) as near-uniform (~0.5) — the number DEPLOY.md tells
    # operators to size the device-cache tier by
    counts = _stable_counts(rows) if rows else []
    return {
        "total": int(table_snap.get("total") or 0),
        "row_bytes": int(table_snap.get("row_bytes") or 0) or None,
        "unique_est": round(float(table_snap.get("unique_est") or 0.0), 1),
        "tracked_topk": len(rows),
        "zipf_alpha": fit_zipf_alpha(counts),
        "coverage": coverage_curve(table_snap, fracs),
        "top_rows": top_rows(table_snap, top_n),
    }


def summary_view(snapshot: Dict, top_n: int = 16) -> Dict:
    """The default /hotness body: everything human-sized, the bulky
    b64 sketch payloads stripped (``?full=1`` serves the mergeable
    form)."""
    if not snapshot.get("enabled"):
        return snapshot
    return {
        "enabled": True,
        "v": snapshot.get("v"),
        "k": snapshot.get("k"),
        "total": snapshot.get("total"),
        "tables": {t: table_report(ts, top_n=top_n)
                   for t, ts in snapshot.get("tables", {}).items()},
    }


def planner_report(snapshot: Dict, hbm_bytes: int,
                   row_bytes: Optional[Dict[str, int]] = None,
                   fracs: Sequence[float] = DEFAULT_COVERAGE_FRACS,
                   num_replicas: Optional[int] = None,
                   measured_hit_rate: Optional[float] = None) -> Dict:
    """HBM plan of the frequency-admitted device cache: ``hbm_bytes``
    split across tables in proportion to their lookup traffic, each
    table's hot set sized, its expected hit rate read off its coverage
    curve. Bytes a row: the caller's ``row_bytes`` (table -> bytes) wins;
    else the snapshot's per-table ``row_bytes`` floored at the f32 width
    ``dim * 4`` (the cache imports rows as f32 values whatever the PS
    stores); optimizer state is left out.

    ``measured_hit_rate`` (a hit rate measured under the planned budget)
    rides beside the prediction with ``hit_rate_delta = predicted -
    measured``; ``num_replicas`` adds :func:`placement_plan`."""
    tables = snapshot.get("tables", {})
    total = float(snapshot.get("total") or 0) or float(
        sum(t.get("total", 0) for t in tables.values())) or 1.0
    plan = []
    overall = 0.0
    for table, t in sorted(tables.items(), key=lambda kv: kv[0]):
        share = float(t.get("total", 0)) / total
        rb = (int((row_bytes or {}).get(table, 0))
              or max(int(t.get("row_bytes") or 0), int(table) * 4))
        budget = int(share * hbm_bytes)
        uniq = max(float(t.get("unique_est") or 0.0), 1.0)
        hot_rows = min(int(budget // rb) if rb else 0, int(uniq))
        curve = coverage_curve(t, fracs=[min(hot_rows / uniq, 1.0)])
        hit = curve[0]["coverage"] if hot_rows else 0.0
        overall += share * hit
        plan.append({
            "table": table,
            "row_bytes": rb,
            "traffic_share": round(share, 6),
            "unique_rows_est": round(uniq, 1),
            "budget_bytes": budget,
            "hot_rows": hot_rows,
            "hot_row_frac": round(hot_rows / uniq, 6),
            "expected_hit_rate": hit,
        })
    doc = {
        "hbm_bytes": int(hbm_bytes),
        "total_lookups": int(total),
        "expected_overall_hit_rate": round(overall, 6),
        "tables": plan,
    }
    if measured_hit_rate is not None:
        doc["measured_overall_hit_rate"] = round(
            float(measured_hit_rate), 6)
        doc["hit_rate_delta"] = round(
            overall - float(measured_hit_rate), 6)
    if num_replicas:
        doc["placement_plan"] = placement_plan(snapshot, num_replicas)
    return doc


def slot_weights(snapshot: Dict, num_slots: int) -> np.ndarray:
    """Per-routing-slot traffic weights from a (merged) snapshot: each
    table's tracked heads (bias-corrected midpoint counts ``c - e/2``)
    land on their slot by the routing table's ``farmhash % num_slots``,
    summed over tables (routing is global); the untracked tail mass
    (total - head) spreads evenly over the slots. Raw lookup counts,
    length ``num_slots``."""
    w = np.zeros(int(num_slots), dtype=np.float64)
    tail_total = 0.0
    for t in snapshot.get("tables", {}).values():
        rows = t.get("topk", ())
        head = 0.0
        if rows:
            signs = np.array([r[0] for r in rows], dtype=np.uint64)
            counts = np.array([max(c - e / 2.0, 0.0)
                               for _s, c, e in rows], dtype=np.float64)
            slots = (farmhash64_np(signs)
                     % np.uint64(num_slots)).astype(np.int64)
            np.add.at(w, slots, counts)
            head = float(counts.sum())
        tail_total += max(float(t.get("total", 0)) - head, 0.0)
    w += tail_total / float(num_slots)
    return w


def placement_plan(snapshot: Dict, num_replicas: int,
                   num_slots: Optional[int] = None,
                   current_table=None) -> Dict:
    """Hotness-balanced slot→replica placement for ``num_replicas``:
    :func:`slot_weights` assigned by the move-minimizing greedy LPT of
    :func:`persia_tpu_torch.reshard.plan_assignment`, reported beside
    what hash-even (``slot % R``) would carry. Every share is rounded to
    6 decimals, so the shares of R replicas sum to 1 within
    ``R * 0.5e-6``, not exactly."""
    from persia_tpu_torch.reshard import plan_assignment
    from persia_tpu_torch.routing import RoutingTable

    if current_table is not None:
        num_slots = current_table.num_slots
    elif num_slots is None:
        num_slots = num_replicas * int(
            knobs.get("PERSIA_ROUTING_SLOTS_PER_REPLICA"))
    if current_table is None:
        current_table = RoutingTable(
            1, np.arange(num_slots, dtype=np.int32)
            % np.int32(num_replicas), num_replicas)
    w = slot_weights(snapshot, num_slots)
    total = float(w.sum()) or 1.0
    assignment = plan_assignment(current_table, num_replicas, w)
    loads = np.bincount(assignment, weights=w, minlength=num_replicas)
    even = np.bincount(
        np.arange(num_slots, dtype=np.int64) % num_replicas,
        weights=w, minlength=num_replicas)
    moved = int(np.count_nonzero(
        assignment != current_table.replica_of_slot))
    return {
        "num_replicas": int(num_replicas),
        "num_slots": int(num_slots),
        "assignment": [int(r) for r in assignment],
        "slot_weights": [round(float(x), 3) for x in w],
        "replica_shares": [round(float(x) / total, 6) for x in loads],
        "max_replica_share": round(float(loads.max()) / total, 6),
        "hash_even_shares": [round(float(x) / total, 6) for x in even],
        "hash_even_max_share": round(float(even.max()) / total, 6),
        "moved_slots": moved,
    }


def fleet_report(snapshot: Dict, hbm_bytes: Optional[int] = None,
                 fracs: Sequence[float] = DEFAULT_COVERAGE_FRACS,
                 num_replicas: Optional[int] = None,
                 measured_hit_rate: Optional[float] = None) -> Dict:
    """The ``/fleet/hotness`` document: merged totals, each table's
    report, the capacity plan when a budget is named, and the placement
    plan when a replica count is named. A ``measured_hit_rate`` without
    a budget and armed telemetry has nothing to be compared with and
    raises."""
    if measured_hit_rate is not None and not (
            hbm_bytes and snapshot.get("enabled")):
        raise ValueError(
            "measured_hit_rate requires an HBM budget (hbm_bytes / "
            "?hbm_gb=) and armed hotness telemetry — there is no "
            "predicted hit rate to compare against without them")
    doc = {
        "enabled": bool(snapshot.get("enabled")),
        "total": int(snapshot.get("total") or 0),
        "tables": {t: table_report(ts, fracs=fracs)
                   for t, ts in snapshot.get("tables", {}).items()},
    }
    if hbm_bytes and snapshot.get("enabled"):
        doc["planner"] = planner_report(snapshot, hbm_bytes, fracs=fracs,
                                        num_replicas=num_replicas,
                                        measured_hit_rate=measured_hit_rate)
    elif num_replicas and snapshot.get("enabled"):
        doc["placement_plan"] = placement_plan(snapshot, num_replicas)
    return doc
