"""The device cache's host side: sign -> slot mappers and the victim
buffer (``persia_tpu/worker/device_cache.py``).

The hybrid path uploads every step's embedding rows and downloads their
gradients. Click-log id streams are Zipf-skewed, so a cache of hot rows on
the card, trained there by a sparse Adagrad of its own, takes the hits
off the wire and off the parameter servers: only miss rows and slot
indices cross, and evicted rows go back to the PS off the training
thread. The device side (cache tensors and the cached steps) is
:mod:`persia_tpu_torch.parallel.cached_train`; the engine tying both to
``TrainCtx`` is :mod:`persia_tpu_torch.parallel.cached_engine`.

- :class:`NativeSignSlotMap`: the LRU mapper in C++ (``ptcm_*`` of
  ``native/src/capi.cc``, ``native/src/cache_map.h``), in the native
  library that :func:`persia_tpu_torch.ps.native.load_native_lib` builds
  from the checkout; the ``lru`` policy;
- :class:`SignSlotMap`: the same contract in Python, the twin the tests
  hold the native mapper against (never a fallback for it);
- :class:`TieredSignSlotMap`: frequency-admitted residency, the
  ``hotness`` policy;
- :class:`VictimBuffer`: evicted rows in flight to the PS, by sign.

Every mapper pins the current batch's signs: an evicted sign that came
back later in the same batch would be read from the PS before its device
value was written back.
"""

import ctypes
import itertools
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.hotness import SpaceSaving
from persia_tpu_torch.ps.native import bind_symbols, load_native_lib


class AssignResult(NamedTuple):
    """One batch's sign->slot mapping (see SignSlotMap.assign)."""

    slots: np.ndarray         # int32 (n,) cache slot per position
    miss_pos: np.ndarray      # int64 (m,) first-occurrence miss positions
    evicted_signs: np.ndarray  # uint64 (m,) victim sign per miss
    evicted_mask: np.ndarray  # bool (m,) True = real eviction (sign 0 is
    #                           a legal sign, so the mask is the marker)
    inverse: np.ndarray       # int32 (n,) position -> batch-distinct index
    unique_slots: np.ndarray  # int32 (n,) distinct index -> slot (tail
    #                           beyond n_unique is uninitialized)
    n_unique: int


_u64, _i32, _i64, _u8 = (ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_uint8)
_P = ctypes.POINTER
# symbol -> (restype, argtypes)
_SIGNATURES = {
    "ptcm_new": (ctypes.c_void_p, [_u64]),
    "ptcm_free": (None, [ctypes.c_void_p]),
    "ptcm_assign": (_i64, [ctypes.c_void_p, _P(_u64), _u64, _P(_i32),
                           _P(_i64), _P(_u64), _P(_u8), _P(_i32), _P(_i32),
                           _P(_i64)]),
    "ptcm_len": (_u64, [ctypes.c_void_p]),
    "ptcm_items": (_u64, [ctypes.c_void_p, _P(_u64), _P(_i32)]),
}

_lock = threading.Lock()
_bound: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The native library with the ``ptcm_*`` entries bound; raises when
    it does not build or lacks one of them."""
    global _bound
    if _bound is None:
        with _lock:
            if _bound is None:
                lib = load_native_lib()
                bind_symbols(lib, _SIGNATURES)
                _bound = lib
    return _bound


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


class NativeSignSlotMap:
    """The C++ LRU mapper: :class:`SignSlotMap`'s contract, bit for bit
    (slot numbers included), at a fraction of its cost on the ~100k
    positions of a bench batch."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = int(capacity)
        self._lib = _lib()
        self._h = self._lib.ptcm_new(self.capacity)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.ptcm_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.ptcm_len(self._h))

    def assign(self, signs: np.ndarray) -> AssignResult:
        """:meth:`SignSlotMap.assign`; a batch of more distinct signs than
        the capacity raises ``ValueError`` and leaves the map as it was."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        slots = np.empty(n, dtype=np.int32)
        miss_pos = np.empty(n, dtype=np.int64)
        evicted = np.empty(n, dtype=np.uint64)
        emask = np.empty(n, dtype=np.uint8)
        inverse = np.empty(n, dtype=np.int32)
        unique_slots = np.empty(n, dtype=np.int32)
        n_unique = ctypes.c_int64(0)
        m = self._lib.ptcm_assign(
            self._h, _ptr(signs, _u64), n, _ptr(slots, _i32),
            _ptr(miss_pos, _i64), _ptr(evicted, _u64), _ptr(emask, _u8),
            _ptr(inverse, _i32), _ptr(unique_slots, _i32),
            ctypes.byref(n_unique))
        if m < 0:
            raise ValueError(
                f"batch distinct signs exceed cache capacity "
                f"{self.capacity}; eviction pinning needs capacity >= "
                "distinct signs per batch")
        self.misses += int(m)
        self.hits += n - int(m)
        self.evictions += int(np.count_nonzero(emask[:m]))
        return AssignResult(
            slots, miss_pos[:m].copy(), evicted[:m].copy(),
            emask[:m].astype(bool), inverse, unique_slots,
            int(n_unique.value))

    def signs_and_slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """All cached (signs, slots)."""
        n = len(self)
        signs = np.empty(n, dtype=np.uint64)
        slots = np.empty(n, dtype=np.int32)
        k = self._lib.ptcm_items(self._h, _ptr(signs, _u64),
                                 _ptr(slots, _i32))
        return signs[:k], slots[:k]

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def make_sign_slot_map(capacity: int, admission: str = "lru"):
    """The mapper of the cache's admission policy: ``lru``, the recency
    mapper in C++ (:class:`NativeSignSlotMap`; a library that does not
    build or bind raises, there is no Python stand-in), or ``hotness``,
    the frequency-admitted :class:`TieredSignSlotMap` in Python."""
    if admission == "hotness":
        return TieredSignSlotMap(capacity)
    if admission != "lru":
        raise ValueError(
            f"unknown device-cache admission policy {admission!r} "
            "(expected 'lru' or 'hotness')")
    return NativeSignSlotMap(capacity)


class SignSlotMap:
    """LRU map from embedding sign -> device cache slot.

    ``assign`` is called once per training batch, on the ordered path
    (batch order defines LRU order). Slots are integers in [0, capacity).
    Eviction picks the least-recently-used sign NOT part of the current
    batch: a victim that reappeared later in the same batch would be
    re-fetched from the PS before its in-flight device value ever got
    flushed, silently losing updates — so current-batch signs are pinned.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = int(capacity)
        # sign -> slot; dict preserves insertion order, and moving a key
        # to the end on touch gives an O(1) LRU
        self._map: Dict[int, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def assign(self, signs: np.ndarray) -> "AssignResult":
        """Map a batch of signs to slots, allocating on miss.

        The returned :class:`AssignResult` fields:
        - slots: int32 (n,) cache slot per sign;
        - miss_pos: int64 positions (within ``signs``) that were misses
          (first occurrence only — a duplicate of an earlier miss in the
          same batch hits the freshly assigned slot);
        - evicted_signs: uint64, same length as miss_pos; the sign whose
          slot was reused for this miss;
        - evicted_mask: bool, same length; True when a victim was
          actually evicted (False = free slot). The mask, not the sign
          value, is the marker: sign 0 is a legal sign (the "missing
          token" convention), so an evicted sign-0 row must still be
          written back (see VictimBuffer).
        """
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        m = self._map
        batch_signs = set(int(s) for s in signs)
        if len(batch_signs) > self.capacity:
            raise ValueError(
                f"batch has {len(batch_signs)} distinct signs but cache "
                f"capacity is {self.capacity}; eviction pinning needs "
                "capacity >= distinct signs per batch")
        slots = np.empty(n, dtype=np.int32)
        inverse = np.empty(n, dtype=np.int32)
        unique_slots = np.empty(n, dtype=np.int32)
        uid: Dict[int, int] = {}
        miss_pos: List[int] = []
        evicted: List[int] = []
        emask: List[bool] = []
        for i in range(n):
            s = int(signs[i])
            slot = m.pop(s, None)
            if slot is not None:  # hit: refresh to MRU
                m[s] = slot
                slots[i] = slot
                self.hits += 1
                u = uid.get(s)
                if u is None:
                    u = uid[s] = len(uid)
                    unique_slots[u] = slot
                inverse[i] = u
                continue
            self.misses += 1
            if self._free:
                slot = self._free.pop()
                evicted.append(0)
                emask.append(False)
            else:
                # evict LRU skipping pinned (current-batch) signs
                victim = next(k for k in m if k not in batch_signs)
                slot = m.pop(victim)
                evicted.append(victim)
                emask.append(True)
                self.evictions += 1
            m[s] = slot
            slots[i] = slot
            u = uid[s] = len(uid)  # a miss is the first occurrence
            unique_slots[u] = slot
            inverse[i] = u
            miss_pos.append(i)
        return AssignResult(
            slots,
            np.asarray(miss_pos, dtype=np.int64),
            np.asarray(evicted, dtype=np.uint64),
            np.asarray(emask, dtype=bool),
            inverse, unique_slots, len(uid))

    def drop(self, sign: int) -> Optional[int]:
        """Remove a sign (after a flush); returns its freed slot."""
        slot = self._map.pop(int(sign), None)
        if slot is not None:
            self._free.append(slot)
        return slot

    def signs_and_slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """All cached (signs, slots) — the flush_all working set."""
        if not self._map:
            return (np.empty(0, np.uint64), np.empty(0, np.int32))
        return (np.fromiter(self._map.keys(), np.uint64, len(self._map)),
                np.fromiter(self._map.values(), np.int32, len(self._map)))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class TieredSignSlotMap:
    """Frequency-admitted sign->slot map: the HBM rung of the embedding
    tier ladder (same ``assign`` contract as :class:`SignSlotMap`).

    Pure LRU lets one-touch cold traffic thrash the cache: every cold
    miss evicts SOME resident row, and under zipfian id streams a large
    share of those victims are rows hot enough to return — each bounce
    costs a PS miss import plus an eviction write-back. This mapper
    splits residency (W-TinyLFU-style) into a small probationary
    **window** (plain LRU — cold churn stays here) and a **protected**
    region whose membership is gated by frequency: a Space-Saving
    sketch (:class:`persia_tpu_torch.hotness.SpaceSaving`, the same
    summary the PS-side telemetry runs) counts the id stream, and a window row
    is promoted only when its count beats the protected LRU victim's.
    Promotion is a pure membership move — the sign keeps its slot, so
    no device row ever has to be copied; evictions therefore stay
    exactly 1:1 with miss imports (the fused step reads an evicted row
    out of precisely the slot the miss overwrites).

    Policy, per distinct batch sign in first-occurrence order (batch
    order defines LRU order at first-occurrence granularity, and
    current-batch signs are pinned, exactly as the LRU mapper):

    - protected hit / window hit: refresh; a window hit additionally
      promotes when the protected region has room (during warm-up, or
      after a miss took a protected row's slot).
    - miss with a free slot: protected while it is warming up, the
      window afterwards.
    - miss at capacity: let the window's LRU candidate ``w`` and the
      protected LRU candidate ``h`` compete on sketch counts. If
      ``count(w) > count(h)``, ``w`` has earned residency: promote it
      (keeping its slot), evict ``h``, and the newcomer takes ``h``'s
      slot in the window. Otherwise evict ``w`` — the one-touch cold
      row dies in the window and the protected set never notices.

    Implementation: membership lives in a flat open-addressing hash
    (sign -> slot, linear probing, tombstone deletes), so a whole
    batch is probed in a handful of vectorized passes; region,
    recency, and the reverse sign map are slot-indexed arrays. Recency
    is a per-batch stamp per slot (LRU = smallest stamp, ties broken
    by slot id) — one fancy assignment refreshes 100k positions where
    an ordered dict pays 100k moves. Within-batch recency order is
    deliberately not tracked: current-batch signs are pinned, so it
    could only ever break ties between rows touched by the same batch.
    ``inverse``/``unique_slots`` fall out of the sign<->slot bijection
    (slot numbers ARE distinct ids) without a second sort. Only the
    miss path (rare once the hot set is resident) loops in python,
    over missing DISTINCT signs.
    """

    _H_MULT = 0x9E3779B97F4A7C15  # fibonacci multiplier, splits u64 keys

    def __init__(self, capacity: int, window_frac: Optional[float] = None,
                 sketch_k: Optional[int] = None):
        if capacity < 2:
            raise ValueError(
                "tiered cache capacity must be >= 2 (one window slot "
                "plus one protected slot)")
        if window_frac is None:
            window_frac = knobs.get("PERSIA_TIER_WINDOW_FRAC")
        if not 0.0 < window_frac < 1.0:
            raise ValueError(
                f"window_frac must be in (0, 1), got {window_frac}")
        if sketch_k is None:
            sketch_k = knobs.get("PERSIA_TIER_SKETCH_TOPK")
        if not sketch_k:
            sketch_k = min(4 * int(capacity), 1 << 20)
        self.capacity = int(capacity)
        self.window_cap = max(1, int(self.capacity * window_frac))
        self.hot_cap = self.capacity - self.window_cap
        # slot-indexed: 0 = free, 1 = window, 2 = protected
        self._state = np.zeros(self.capacity, dtype=np.int8)
        self._sign = np.zeros(self.capacity, dtype=np.uint64)
        self._stamp = np.zeros(self.capacity, dtype=np.int64)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._hot_n = 0
        self._win_n = 0
        self._clock = 0
        self._sketch = SpaceSaving(int(sketch_k))
        # W-TinyLFU-style aging: halve the sketch once per this many
        # observed positions, so a hot-set shift can't leave stale
        # giants blocking admission forever (a newly hot row only has
        # to out-count the old guard's DECAYED counts)
        self._decay_window = 16 * self.capacity
        self._decay_left = self._decay_window
        # open-addressing sign -> slot index, load factor <= 0.5 at
        # full residency (emptiness lives in the slot value: -1 empty,
        # -2 tombstone; sign 0 is a legal key)
        size = 8
        while size < 2 * self.capacity:
            size <<= 1
        self._h_size = size
        self._h_mask = size - 1
        self._h_shift = 65 - size.bit_length()
        self._h_sign = np.zeros(size, dtype=np.uint64)
        self._h_slot = np.full(size, -1, dtype=np.int32)
        self._h_fill = 0  # occupied + tombstones (what bounds probes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.promotions = 0

    def __len__(self) -> int:
        return self._hot_n + self._win_n

    # --- sign -> slot hash (membership) ---------------------------------

    def _h_probe(self, keys: np.ndarray) -> np.ndarray:
        """Bulk lookup: int32 slot per key, -1 for absent. Each round
        resolves every key whose current probe cell is a hit (slot
        found) or a virgin empty (definitely absent); mismatched
        occupied cells and tombstones advance to the next cell."""
        mask = self._h_mask
        out = np.full(len(keys), -1, dtype=np.int32)
        idx = ((keys * np.uint64(self._H_MULT))
               >> np.uint64(self._h_shift)).astype(np.int64)
        pend = np.arange(len(keys))
        kp = keys
        while len(pend):
            sl = self._h_slot[idx]
            found = (sl >= 0) & (self._h_sign[idx] == kp)
            if found.any():
                out[pend[found]] = sl[found]
            cont = ~found & (sl != -1)
            pend = pend[cont]
            kp = kp[cont]
            idx = (idx[cont] + 1) & mask
        return out

    def _h_find_pos(self, sign: int) -> int:
        """Scalar probe: table cell holding ``sign``, or -1."""
        mask = self._h_mask
        h_sign, h_slot = self._h_sign, self._h_slot
        i = ((sign * self._H_MULT) & 0xFFFFFFFFFFFFFFFF) >> self._h_shift
        while True:
            sl = h_slot[i]
            if sl == -1:
                return -1
            if sl >= 0 and h_sign[i] == sign:
                return i
            i = (i + 1) & mask

    def _h_insert(self, sign: int, slot: int) -> None:
        """Scalar insert (caller guarantees ``sign`` is absent).
        Tombstones are reclaimed; virgin empties grow the fill, and
        when fill passes 3/4 the table is rebuilt tombstone-free
        (amortized over >= size/4 deletes — residency itself can never
        pass 1/2)."""
        mask = self._h_mask
        h_slot = self._h_slot
        i = ((sign * self._H_MULT) & 0xFFFFFFFFFFFFFFFF) >> self._h_shift
        while h_slot[i] >= 0:
            i = (i + 1) & mask
        if h_slot[i] == -1:
            self._h_fill += 1
        self._h_sign[i] = sign
        h_slot[i] = slot
        if 4 * self._h_fill > 3 * self._h_size:
            self._h_rebuild()

    def _h_rebuild(self) -> None:
        mask = self._h_mask
        self._h_sign = np.zeros(self._h_size, dtype=np.uint64)
        self._h_slot = np.full(self._h_size, -1, dtype=np.int32)
        h_sign, h_slot = self._h_sign, self._h_slot
        res = np.nonzero(self._state > 0)[0]
        for slot, sign in zip(res.tolist(),
                              self._sign[res].tolist()):
            i = ((sign * self._H_MULT) & 0xFFFFFFFFFFFFFFFF) \
                >> self._h_shift
            while h_slot[i] != -1:
                i = (i + 1) & mask
            h_sign[i] = sign
            h_slot[i] = slot
        self._h_fill = len(res)

    def _victim_queues(self, uniq: np.ndarray):
        """Per-assign eviction cursors: each region's unpinned slots in
        LRU (stamp) order plus their sketch counts, all frozen for the
        whole batch (the batch is folded into the sketch before any
        eviction decision). One sort + one bulk count query replaces
        the per-miss pinned-prefix rescan and per-victim point probe,
        which went quadratic once the map reached capacity. Entries
        that leave their region mid-batch (promotion) or whose slot
        was reused (eviction) are skipped at the cursor."""
        res = np.nonzero(self._state > 0)[0]
        res = res[np.argsort(self._stamp[res], kind="stable")]
        sgs = self._sign[res]
        unpinned = ~np.isin(sgs, uniq)
        st = self._state[res]
        wm = (st == 1) & unpinned
        hm = (st == 2) & unpinned
        wcnts = self._sketch.counts_of(sgs[wm])
        hcnts = self._sketch.counts_of(sgs[hm])
        return [res[wm].tolist(), sgs[wm].tolist(), wcnts.tolist(), 0,
                res[hm].tolist(), sgs[hm].tolist(), hcnts.tolist(), 0]

    def _admit(self, uniq, mu, order, mslots):
        """Slot allocation for this batch's missing distinct signs
        ``mu`` (sign-sorted; visited in batch first-occurrence order
        via ``order``): free slots while they last, then the
        window-vs-protected victim competition of the class docstring.
        Fills ``mslots`` (aligned with ``mu``) and returns the
        per-miss (evicted sign, real-eviction mask) in visit order."""
        state, sgn = self._state, self._sign
        evicted = np.zeros(len(mu), dtype=np.uint64)
        emask = np.zeros(len(mu), dtype=bool)
        vq = None  # victim queues, built on the first at-capacity miss
        for k, j in enumerate(order.tolist()):
            s = int(mu[j])
            if self._free:
                slot = self._free.pop()
                if self._hot_n < self.hot_cap:
                    state[slot] = 2  # warm-up: no signal to gate on yet
                    self._hot_n += 1
                else:
                    state[slot] = 1
                    self._win_n += 1
            else:
                while True:
                    if vq is None:
                        vq = self._victim_queues(uniq)
                    (wslots, wsigns, wcnts, wi,
                     hslots, hsigns, hcnts, hi) = vq
                    while wi < len(wslots) and not (
                            state[wslots[wi]] == 1
                            and sgn[wslots[wi]] == wsigns[wi]):
                        wi += 1
                    while hi < len(hslots) and not (
                            state[hslots[hi]] == 2
                            and sgn[hslots[hi]] == hsigns[hi]):
                        hi += 1
                    w_ok, h_ok = wi < len(wslots), hi < len(hslots)
                    if w_ok or h_ok:
                        break
                    # both cursors dry: each competition consumed TWO
                    # entries (promoted w + evicted h), so the frozen
                    # queues can exhaust while unpinned residents
                    # remain (capacity >= batch distinct guarantees
                    # one per remaining miss) — rebuild and continue
                    vq = None
                if w_ok and h_ok and wcnts[wi] > hcnts[hi]:
                    # the window candidate out-counts the protected
                    # victim: it earned residency — promote it (its
                    # slot moves with it), evict the protected LRU,
                    # and the newcomer takes the freed slot. Region
                    # counts net out: one in, one out of each.
                    state[wslots[wi]] = 2
                    wi += 1
                    victim, slot = hsigns[hi], hslots[hi]
                    hi += 1
                    self.promotions += 1
                elif w_ok:
                    victim, slot = wsigns[wi], wslots[wi]
                    wi += 1
                else:
                    victim, slot = hsigns[hi], hslots[hi]
                    hi += 1
                    self._hot_n -= 1
                    self._win_n += 1
                vq[3], vq[7] = wi, hi
                pos = self._h_find_pos(victim)
                self._h_slot[pos] = -2  # tombstone keeps chains intact
                state[slot] = 1  # newcomers enter through the window
                evicted[k] = victim
                emask[k] = True
                self.evictions += 1
            # reverse map first: _h_insert may trigger _h_rebuild, which
            # re-derives the hash from _state/_sign — a stale sgn[slot]
            # would resurrect the previous occupant as a live alias
            sgn[slot] = s
            self._h_insert(s, slot)
            mslots[j] = slot
        return evicted, emask

    def assign(self, signs: np.ndarray) -> AssignResult:
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        if n == 0:
            return AssignResult(
                np.empty(0, np.int32), np.empty(0, np.int64),
                np.empty(0, np.uint64), np.empty(0, bool),
                np.empty(0, np.int32), np.empty(0, np.int32), 0)
        uniq, ucounts = np.unique(signs, return_counts=True)
        nu = len(uniq)
        if nu > self.capacity:
            raise ValueError(
                f"batch has {nu} distinct signs but cache "
                f"capacity is {self.capacity}; eviction pinning needs "
                "capacity >= distinct signs per batch")
        # fold the batch into the admission sketch first (vectorized),
        # so this batch's own touches count toward its admissions
        self._decay_left -= n
        if self._decay_left <= 0:
            self._sketch.decay()
            self._decay_left = self._decay_window
        self._sketch.offer_many(uniq, ucounts.astype(np.float64))
        pslots = self._h_probe(signs)  # per-position; -1 = miss
        n_miss = 0
        miss_pos = np.empty(0, dtype=np.int64)
        evicted = np.empty(0, dtype=np.uint64)
        emask = np.empty(0, dtype=bool)
        hit_any = int(pslots.max(initial=-1)) >= 0
        if hit_any and self._hot_n < self.hot_cap:
            # window hits promote while the protected region has room
            # (warm-up, or a protected slot given to a miss) —
            # membership moves, slots never do
            hflag = np.zeros(self.capacity, dtype=bool)
            hflag[pslots[pslots >= 0]] = True
            wh = np.nonzero(hflag & (self._state == 1))[0]
            room = self.hot_cap - self._hot_n
            if len(wh):
                wh = wh[:room]
                self._state[wh] = 2
                self._hot_n += len(wh)
                self._win_n -= len(wh)
                self.promotions += len(wh)
        mpos_all = np.nonzero(pslots < 0)[0]
        if len(mpos_all):
            msigns = signs[mpos_all]
            mu, m_first = np.unique(msigns, return_index=True)
            n_miss = len(mu)
            # visit misses in batch (first-occurrence) order; m_first
            # indexes the ascending mpos_all, so it orders positions
            order = np.argsort(m_first, kind="stable")
            miss_pos = mpos_all[m_first[order]].astype(np.int64)
            mslots = np.empty(n_miss, dtype=np.int32)
            evicted, emask = self._admit(uniq, mu, order, mslots)
            pslots[mpos_all] = mslots[np.searchsorted(mu, msigns)]
        self.hits += n - n_miss
        self.misses += n_miss
        # one batch = one recency tick for every touched slot (ties
        # break by slot id; within-batch order can't matter — pinning)
        self._stamp[pslots] = self._clock
        self._clock += 1
        # resident sign <-> slot is a bijection, so slot numbers ARE
        # distinct ids: dense-rank them for inverse/unique_slots
        flag = np.zeros(self.capacity, dtype=bool)
        flag[pslots] = True
        us = np.nonzero(flag)[0]
        remap = np.zeros(self.capacity, dtype=np.int32)
        remap[us] = np.arange(nu, dtype=np.int32)
        unique_slots = np.empty(n, dtype=np.int32)
        unique_slots[:nu] = us
        return AssignResult(
            pslots, miss_pos, evicted, emask,
            remap[pslots], unique_slots, nu)

    def drop(self, sign: int) -> Optional[int]:
        """Remove a sign; returns its freed slot."""
        pos = self._h_find_pos(int(sign))
        if pos < 0:
            return None
        slot = int(self._h_slot[pos])
        self._h_slot[pos] = -2
        if self._state[slot] == 2:
            self._hot_n -= 1
        else:
            self._win_n -= 1
        self._state[slot] = 0
        self._free.append(slot)
        return slot

    def signs_and_slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """All cached (signs, slots) across both regions."""
        res = np.nonzero(self._state > 0)[0]
        if len(res) == 0:
            return (np.empty(0, np.uint64), np.empty(0, np.int32))
        return (self._sign[res].copy(), res.astype(np.int32))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class VictimBuffer:
    """Evicted rows in flight to the PS, by sign.

    The write-back runs on the engine's flush thread. Until it lands, the
    PS copy of an evicted sign is stale, so a miss on that sign reads the
    buffered row, not the PS. A payload is whatever the engine stores:
    host arrays filled by an asynchronous device-to-host copy and the
    event that says when they hold the row."""

    def __init__(self):
        # sign -> (token, payload). The token names the eviction that made
        # the entry: a write-back job consumes only its own, or
        # this sequence loses an update: evict (job A) -> a miss takes the
        # row back -> evict again (job B); a plain take by job A would
        # steal B's newer entry and write A's older value to the PS.
        self._pending: Dict[int, Tuple[int, object]] = {}
        self._lock = threading.Lock()

    # every form takes a batch of signs (Python ints) under one lock

    def put_many(self, signs: Sequence[int], payloads: Iterable,
                 token: int = 0) -> None:
        """File each (sign, payload) under ``token``, a newer entry of a
        sign replacing an older one."""
        with self._lock:
            self._pending.update(zip(signs, zip(itertools.repeat(token),
                                                payloads)))

    def take_many(self, signs: Sequence[int]) -> list:
        """Remove each sign's entry: its payload or None (the miss path).
        A pending entry is the newest copy, so no token is checked."""
        with self._lock:
            pop = self._pending.pop
            entries = [pop(s, None) for s in signs]
        return [None if e is None else e[1] for e in entries]

    def peek_if_many(self, signs: Sequence[int], token: int) -> list:
        """Each sign's payload, not removed, where its token is
        ``token``, else None. The write-back peeks, writes the PS, then
        removes with :meth:`take_if_many`: removing before the write
        landed would let a concurrent miss find nothing here and read the
        stale PS row."""
        with self._lock:
            get = self._pending.get
            entries = [get(s) for s in signs]
        return [e[1] if e is not None and e[0] == token else None
                for e in entries]

    def take_if_many(self, signs: Sequence[int], token: int) -> int:
        """Remove the entries of ``signs`` whose token is ``token`` (the
        write-back, after its PS write landed); returns how many."""
        with self._lock:
            pending = self._pending
            mine = [s for s in dict.fromkeys(signs)
                    if (e := pending.get(s)) is not None and e[0] == token]
            for s in mine:
                del pending[s]
        return len(mine)

    def pop_any(self):
        """Remove and return an arbitrary (sign, payload), or None."""
        with self._lock:
            if not self._pending:
                return None
            sign = next(iter(self._pending))
            return sign, self._pending.pop(sign)[1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)
