"""The device cache's engine (``persia_tpu/parallel/cached_engine.py``).

:class:`DeviceCacheEngine` ties the host's sign -> slot mapper and victim
buffer (:mod:`persia_tpu_torch.worker.device_cache`) to the cache tensors
on the device (:mod:`persia_tpu_torch.parallel.cached_train`), and owns
the write-back of evicted rows to the parameter servers on a flush
thread. ``TrainCtx`` delegates to it when ``device_cache_capacity`` is
set.

Consistency: a cached row trains only on the device; its PS copy is stale
until the row is evicted (written back) or :meth:`flush_all` runs (the
eval, checkpoint and snapshot entry points call it). A miss reads the
victim buffer before the PS, so a row evicted and wanted again never
loses its update in flight. One trainer only: caches replicated over
trainers would fork hot rows' optimizer state. A rank of the port is a
process, so ``TrainCtx`` over a mesh of more than one rank negotiates the
cache off (``PERSIA_MULTIHOST_CACHE``), as the JAX package does over more
than one process.

The cache tensors change in place at every step, where the JAX arrays
are immutable. So the evicted rows a step returns are new tensors, and
:meth:`finish` copies them into pinned host memory on the training
thread's stream, recording an event after the copy: the flush thread and
a miss that reads a buffered row wait for that event, never for a tensor
a later step overwrites. :meth:`flush_all` reads the cache after the
flush queue drained, by a copy on the training thread's stream, which
orders it after every step.

The JAX engine's registry counters wait for the metrics registry
(ROADMAP.md queue A item 6); the port keeps them as plain ints, read by
:meth:`stats`.
"""

import itertools
import logging
import queue
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from persia_tpu_torch import knobs
from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.parallel.cached_train import (
    init_cache_arrays,
    pad_to_bucket,
)
from persia_tpu_torch.worker.device_cache import (
    VictimBuffer,
    make_sign_slot_map,
)

_logger = logging.getLogger(__name__)

_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)

# the engine's counters, each the JAX engine's registry counter
# device_cache_<name>_total
COUNTERS = ("probes", "hits", "misses", "evictions", "promotions",
            "writeback_rows")


class _HostRows(NamedTuple):
    """A step's evicted rows in host memory: ``vals`` and ``acc`` hold
    them once ``event`` (None on the CPU) has completed."""

    vals: np.ndarray
    acc: np.ndarray
    event: Optional[torch.cuda.Event]

    def ready(self) -> "_HostRows":
        if self.event is not None:
            self.event.synchronize()
        return self


def _to_host(ev_vals: torch.Tensor, ev_acc: torch.Tensor) -> _HostRows:
    """Start the copy of evicted rows to the host: on the card an
    asynchronous copy into pinned buffers on the current stream and an
    event after it; on the CPU the rows themselves (new tensors that no
    later step writes)."""
    if ev_vals.device.type != "cuda":
        return _HostRows(ev_vals.numpy(), ev_acc.numpy(), None)
    vals = torch.empty(ev_vals.shape, dtype=torch.float32, pin_memory=True)
    acc = torch.empty(ev_acc.shape, dtype=torch.float32, pin_memory=True)
    vals.copy_(ev_vals, non_blocking=True)
    acc.copy_(ev_acc, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return _HostRows(vals.numpy(), acc.numpy(), event)


class DeviceCacheEngine:
    """``capacity`` rows of ``dim`` f32 values and Adagrad accumulators
    (starting at ``acc_init``) on ``device`` (default CUDA), for
    ``num_slots`` summed slots; ``sqrt_scaling`` is each slot's flag (bag
    mode), ``admission`` the mapper's policy (default the
    ``PERSIA_TIER_ADMIT`` knob, ``lru``). ``wire_bytes_saved`` counts what
    the packed path (bf16 both ways) would have moved less what the cached
    path moved."""

    def __init__(self, worker, capacity: int, num_slots: int, dim: int,
                 acc_init: float, sqrt_scaling=None,
                 admission: Optional[str] = None,
                 device: DeviceLike = None):
        self.worker = worker
        self.capacity = int(capacity)
        self.num_slots = int(num_slots)
        self.dim = int(dim)
        self.acc_init = float(acc_init)
        self.device = resolve_device(device)
        # the card the flush thread binds (a new thread has no current
        # device; waiting on an event needs the card's context)
        self._cuda_index = (None if self.device.type != "cuda" else
                            self.device.index if self.device.index is not None
                            else torch.cuda.current_device())
        self.sqrt_scaling = list(sqrt_scaling or [])
        self.admission = admission or knobs.get("PERSIA_TIER_ADMIT")
        self.mapper = make_sign_slot_map(capacity, self.admission)
        self.victims = VictimBuffer()
        self.cache_vals, self.cache_acc = init_cache_arrays(
            capacity, dim, acc_init, self.device)
        self._flush_q: "queue.Queue" = queue.Queue()
        self._flush_token = 0
        self._flush_err: List[BaseException] = []
        self._flush_thread = self._start_flush_thread()
        self.wire_bytes_saved = 0
        self._counts_lock = threading.Lock()
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._counted = (0, 0, 0, 0)  # the mapper's hits/misses/evictions/
        #                               promotions already counted

    def _start_flush_thread(self) -> threading.Thread:
        t = threading.Thread(target=self._flush_loop, daemon=True,
                             name="device-cache-flush")
        t.start()
        return t

    def _count(self, name: str, n: int):
        with self._counts_lock:
            self._counts[name] += n

    def _publish_counters(self):
        """The mapper's counters' deltas since the last batch into the
        engine's (once a batch, after assign)."""
        m = self.mapper
        now = (m.hits, m.misses, m.evictions, getattr(m, "promotions", 0))
        d = [a - b for a, b in zip(now, self._counted)]
        self._counted = now
        with self._counts_lock:
            for name, n in zip(("hits", "misses", "evictions",
                                "promotions"), d):
                self._counts[name] += n
            self._counts["probes"] += d[0] + d[1]

    def stats(self) -> dict:
        """The counters (:data:`COUNTERS`, cumulative over the engine's
        life) and ``resident_rows``, the signs cached now."""
        with self._counts_lock:
            out = dict(self._counts)
        out["resident_rows"] = len(self.mapper)
        return out

    # --- per-batch host work ----------------------------------------------

    def prepare(self, id_type_features) -> Tuple[np.ndarray, ...]:
        """Map this batch's signs and fetch its miss rows.

        Returns (slot_idx (B,S) i32, cold_idx (Mpad,) i32, cold_vals
        (Mpad, D) f32, cold_acc (Mpad, D) f32, evicted_signs (Mpad,) u64,
        evicted_mask (Mpad,) bool, inverse (B*S,) i32, unique_slots (B*S,)
        i32). Runs on the ordered training path: batch order is the LRU
        order."""
        # single-id slots: one sign a sample (the context checked the
        # features' type before building the engine)
        signs = np.stack([f.signs for f in id_type_features], axis=1)
        batch, num_slots = signs.shape
        flat_signs = signs.reshape(-1)
        res = self.mapper.assign(flat_signs)
        self._publish_counters()
        # the tail past the distinct count is uninitialized: point it at
        # the dummy slot, so the device update's pad rows are inert
        unique_slots = res.unique_slots
        unique_slots[res.n_unique:] = self.capacity
        slot_idx = res.slots.reshape(batch, num_slots)
        (cold_idx, cold_vals, cold_acc, evicted_signs, evicted_mask,
         mpad) = self._miss_import(flat_signs, res)
        packed = batch * num_slots * self.dim * 2 * 2
        moved = (slot_idx.nbytes + cold_idx.nbytes + cold_vals.nbytes
                 + cold_acc.nbytes + (2 * mpad * self.dim * 4))
        self.wire_bytes_saved += max(0, packed - moved)
        return (slot_idx, cold_idx, cold_vals, cold_acc, evicted_signs,
                evicted_mask, res.inverse, unique_slots)

    def prepare_bags(self, id_type_features) -> Tuple[np.ndarray, ...]:
        """:meth:`prepare` for summed bag slots of any length.

        Flattens every (sample, slot) bag into one position list (slot
        major), maps it through the same assign, and returns
        (flat_slot_idx (Lpad,) i32, seg (Lpad,) i32, scale (B, S) f32,
        cold_idx, cold_vals, cold_acc, evicted_signs, evicted_mask,
        inverse (Lpad,) i32, unique_slots (Lpad,) i32) for
        ``make_cached_bag_train_step``. Pad positions carry seg == B*S
        (the trash bag row) and the dummy slot."""
        batch = id_type_features[0].batch_size
        num_slots = len(id_type_features)
        sign_parts, seg_parts, counts = [], [], []
        for s, f in enumerate(id_type_features):
            cnt = np.diff(f.offsets.astype(np.int64))
            counts.append(cnt)
            sign_parts.append(f.signs)
            seg_parts.append(
                np.repeat(np.arange(batch, dtype=np.int64) * num_slots + s,
                          cnt))
        flat_signs = np.concatenate(sign_parts).astype(np.uint64)
        seg = np.concatenate(seg_parts)
        n = len(flat_signs)
        res = self.mapper.assign(flat_signs)
        self._publish_counters()
        lpad = pad_to_bucket(max(n, 1), _BUCKETS)
        flat_slot_idx = np.full(lpad, self.capacity, np.int32)
        flat_slot_idx[:n] = res.slots
        seg_pad = np.full(lpad, batch * num_slots, np.int32)
        seg_pad[:n] = seg
        # pad entries add the (zero) trash-row gradient to distinct index
        # 0, which changes nothing
        inverse = np.zeros(lpad, np.int32)
        inverse[:n] = res.inverse
        unique_slots = np.full(lpad, self.capacity, np.int32)
        unique_slots[:res.n_unique] = res.unique_slots[:res.n_unique]
        # the middleware's 1/sqrt(max(bag size, 1)) a (sample, slot)
        scale = np.ones((batch, num_slots), np.float32)
        for s in range(num_slots):
            if self.sqrt_scaling and self.sqrt_scaling[s]:
                scale[:, s] = 1.0 / np.sqrt(
                    np.maximum(counts[s], 1).astype(np.float32))
        (cold_idx, cold_vals, cold_acc, evicted_signs, evicted_mask,
         mpad) = self._miss_import(flat_signs, res)
        packed = batch * num_slots * self.dim * 2 * 2
        moved = (flat_slot_idx.nbytes + seg_pad.nbytes + scale.nbytes
                 + cold_idx.nbytes + cold_vals.nbytes + cold_acc.nbytes
                 + (2 * mpad * self.dim * 4))
        self.wire_bytes_saved += max(0, packed - moved)
        return (flat_slot_idx, seg_pad, scale, cold_idx, cold_vals,
                cold_acc, evicted_signs, evicted_mask, inverse,
                unique_slots)

    def _miss_import(self, flat_signs, res):
        """This batch's miss rows (victim buffer first, then the PS),
        bucket-padded: pads target the dummy slot with zero values and
        ``acc_init`` state. Returns (cold_idx, cold_vals, cold_acc,
        evicted_signs, evicted_mask, mpad)."""
        miss_signs = flat_signs[res.miss_pos]
        m = len(miss_signs)
        mpad = pad_to_bucket(max(m, 1), _BUCKETS)
        cold_idx = np.full(mpad, self.capacity, np.int32)
        cold_vals = np.zeros((mpad, self.dim), np.float32)
        cold_acc = np.full((mpad, self.dim), self.acc_init, np.float32)
        evicted_signs = np.zeros(mpad, np.uint64)
        evicted_mask = np.zeros(mpad, bool)
        if m:
            cold_idx[:m] = res.slots[res.miss_pos]
            evicted_signs[:m] = res.evicted_signs
            evicted_mask[:m] = res.evicted_mask
            # the victim buffer first: a row whose write-back has not
            # landed is the newest copy; its host arrays are read once
            # the copy that fills them has run. With nothing in flight
            # every miss reads the PS.
            need_ps = range(m)
            if len(self.victims):
                need_ps, by_host = [], {}
                for i, v in enumerate(
                        self.victims.take_many(miss_signs.tolist())):
                    if v is None:
                        need_ps.append(i)
                    else:
                        by_host.setdefault(id(v[0]), (v[0], [], []))
                        by_host[id(v[0])][1].append(i)
                        by_host[id(v[0])][2].append(v[1])
                for host, pos, rows in by_host.values():
                    host.ready()
                    cold_vals[pos] = host.vals[rows]
                    cold_acc[pos] = host.acc[rows]
            if len(need_ps):
                idx = np.asarray(need_ps)
                vals, state = self.worker.lookup_rows_with_state(
                    miss_signs[idx], self.dim, default_state=self.acc_init)
                cold_vals[idx] = vals
                cold_acc[idx] = state
        return (cold_idx, cold_vals, cold_acc, evicted_signs, evicted_mask,
                mpad)

    def finish(self, evicted_signs: np.ndarray, evicted_mask: np.ndarray,
               ev_vals: torch.Tensor, ev_acc: torch.Tensor) -> None:
        """Queue a step's evicted rows for the PS write-back: their copy
        to the host starts here, on the training thread's stream. The mask
        (not the sign's value) selects real evictions: sign 0 is legal. A
        write-back that failed raises here."""
        if self._flush_err:
            raise self._flush_err[0]
        real = np.nonzero(evicted_mask)[0]
        if not len(real):
            return
        rows = int(real[-1]) + 1
        host = _to_host(ev_vals[:rows], ev_acc[:rows])
        self._flush_token += 1
        token = self._flush_token
        self.victims.put_many(evicted_signs[real].tolist(),
                              zip(itertools.repeat(host), real.tolist()),
                              token=token)
        self._flush_q.put((token, evicted_signs, real, host))

    # --- write-back -------------------------------------------------------

    def _flush_loop(self):
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            job = self._flush_q.get()
            if job is None:
                self._flush_q.task_done()
                return
            try:
                self._flush_job(*job)
            except BaseException as e:  # raised by the next finish()
                self._flush_err.append(e)
            finally:
                self._flush_q.task_done()

    def _flush_job(self, token, evicted_signs, real, host: _HostRows):
        host.ready()
        # peek, not take: if an entry is gone or has another token, a miss
        # took the row back (the cache copy rules again) or a newer
        # eviction owns the sign; writing this older value would clobber
        # newer state
        mine = np.asarray([p is not None for p in self.victims.peek_if_many(
            evicted_signs[real].tolist(), token)], bool)
        rows = real[mine]
        if len(rows):
            signs = evicted_signs[rows]
            self.worker.set_rows(
                signs, np.concatenate([host.vals[rows], host.acc[rows]],
                                      axis=1), self.dim)
            self._count("writeback_rows", len(rows))
            # removed only after the PS write landed: a miss racing the
            # write must still find the entry, or it would read the stale
            # PS row
            self.victims.take_if_many(signs.tolist(), token)

    def flush_all(self) -> int:
        """Write every cached row (and the victim buffer) back to the PS,
        once the queued write-backs landed; the cache stays valid for more
        training. Returns the rows written."""
        self._drain_flush_queue()
        signs, slots = self.mapper.signs_and_slots()
        n = len(signs)
        if n:
            idx = torch.from_numpy(slots.astype(np.int64)).to(self.device)
            # copies on this thread's stream, ordered after every step it ran
            vals = self.cache_vals.index_select(0, idx).cpu().numpy()
            acc = self.cache_acc.index_select(0, idx).cpu().numpy()
            self.worker.set_rows(signs, np.concatenate([vals, acc], axis=1),
                                 self.dim)
            self._count("writeback_rows", n)
        while True:
            item = self.victims.pop_any()
            if item is None:
                break
            # after the drain this is normally empty; a row left behind
            # (a flush after close()) is still written back
            sign, (host, row) = item
            host.ready()
            self.worker.set_rows(
                np.asarray([sign], np.uint64),
                np.concatenate([host.vals[row], host.acc[row]])[None, :],
                self.dim)
            self._count("writeback_rows", 1)
            n += 1
        return n

    def invalidate(self) -> None:
        """Drop every cached row WITHOUT writing it back (a checkpoint or
        snapshot restore: the cache predates the loaded rows). Queued
        write-backs land first, before the restore overwrites them."""
        self._drain_flush_queue()
        while self.victims.pop_any() is not None:
            pass
        self.mapper = make_sign_slot_map(self.capacity, self.admission)
        self._counted = (0, 0, 0, 0)
        with torch.no_grad():
            self.cache_vals.zero_()
            self.cache_acc.fill_(self.acc_init)

    def _drain_flush_queue(self):
        """Block until the queued write-backs have landed (a flush_all
        must not be overwritten by an older eviction landing later);
        task_done makes join() cover the job in progress."""
        self._flush_q.join()
        if self._flush_err:
            raise self._flush_err[0]

    def close(self):
        """Stop the flush thread (``TrainCtx.__exit__``). The cache and
        the mapper stay valid; :meth:`ensure_open` restarts the thread."""
        if self._flush_thread.is_alive():
            self._flush_q.put(None)
            self._flush_thread.join(timeout=30)

    def ensure_open(self):
        if not self._flush_thread.is_alive():
            # an error kept from the context's previous life was raised at
            # its exit, or that exit was on another exception and skipped
            # the flush, losing those write-backs: say so, and start clean
            if self._flush_err:
                _logger.warning(
                    "device-cache: discarding %d unraised write-back "
                    "error(s) from the previous context (first: %r); the "
                    "PS updates queued before the abnormal exit were lost",
                    len(self._flush_err), self._flush_err[0])
            self._flush_err.clear()
            self._flush_thread = self._start_flush_thread()

    @property
    def hit_rate(self) -> float:
        return self.mapper.hit_rate
