"""The native C++ PS store and the choice of a holder
(``persia_tpu/ps/native.py``).

The store is the C++ arena of ``native/src/store.h``, reached through the
C interface of ``native/src/capi.cc``. The port builds that library
itself, at first use, from the sources in the checkout:

- ``g++`` with the flags of ``native/Makefile``'s ``libpersia_native.so``
  (:data:`CXXFLAGS`; ``-ffp-contract=off`` keeps the bit parity with the
  numpy twins), into ``persia_tpu_torch/_build/libpersia_native-<hash>.so``;
- the hash covers ``capi.cc``, every ``native/src/*.h``, the flags, and
  the host's machine and CPU flags (``-march=native`` makes a library that
  may not run on another CPU);
- the compiler writes a private name that is renamed into place
  (:func:`persia_tpu_torch.ops._build.compile_all`), so test processes
  building at once never load a half-written library;
- a failed build raises with the compiler's output, and a library missing
  any symbol the port calls is an error (:func:`bind_symbols`): it is
  always built from the current sources, so there is nothing to negotiate
  down to. Each module binds the entries it calls: this one the store's
  ``ptps_*``, :mod:`persia_tpu_torch.worker.mw_native` the middleware's
  ``ptmw_*``.

Nothing runs at import time. :class:`NativeEmbeddingHolder` has the
interface of the Python holders, and the same semantics and PSD v1/v2
bytes. ctypes releases the interpreter lock for every foreign call, so
lookups and updates on other threads run while the training thread holds
it. :func:`make_holder` returns it by default.

The disk spill tier and the hotness sketches live in the Python wrapper,
as in the JAX package: with ``spill_dir`` the store retains its evicted
rows (``ptps_set_retain_evicted``), the wrapper drains them after each
call into the shared :class:`~persia_tpu_torch.ps.spill.SpillStore` and
faults spilled rows back in before a call that needs them.
"""

import contextlib
import ctypes
import hashlib
import os
import platform
import shutil
import struct
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.hotness import disabled_snapshot, make_tracker
from persia_tpu_torch.ops._build import BUILD_DIR, Job, compile_all
from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder
from persia_tpu_torch.ps.optim import RowPrecision, SparseOptimizer
from persia_tpu_torch.ps.spill import SpillStore
from persia_tpu_torch.ps.store import (
    EmbeddingHolder,
    iter_psd_records,
    read_psd_header,
)

REPO_DIR = Path(__file__).resolve().parent.parent.parent
NATIVE_SRC_DIR = REPO_DIR / "native" / "src"
# native/Makefile's libpersia_native.so flags (its warnings left out)
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
            "-fPIC", "-shared", "-pthread")

_INIT_METHOD_CODES = {
    "bounded_uniform": 0,
    "bounded_gamma": 1,
    "bounded_poisson": 2,
    "normal": 3,
    "truncated_normal": 4,
    "zero": 5,
}
_ROW_DTYPE_CODES = {"fp32": 0, "fp16": 1, "bf16": 2}

_u64, _u32, _i32, _i64 = (ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_int64)
_u8 = ctypes.c_uint8
_vp, _f32 = ctypes.c_void_p, ctypes.c_float
_P = ctypes.POINTER
# symbol -> (restype, argtypes) of every entry the port calls
_SIGNATURES = {
    "ptps_new2": (_vp, [_u64, _u32, _i32, _u64]),
    "ptps_free": (None, [_vp]),
    "ptps_configure": (None, [_vp, _i32, _P(ctypes.c_double), _f32, _f32,
                              _i32]),
    "ptps_register_optimizer": (_i32, [_vp, ctypes.c_char_p]),
    "ptps_lookup": (_i32, [_vp, _P(_u64), _u64, _u32, _i32, _P(_f32)]),
    "ptps_update": (_i32, [_vp, _P(_u64), _u64, _u32, _P(_f32)]),
    "ptps_len": (_u64, [_vp]),
    "ptps_clear": (None, [_vp]),
    "ptps_index_miss_count": (_u64, [_vp]),
    "ptps_gradient_id_miss_count": (_u64, [_vp]),
    "ptps_get_entry": (_i64, [_vp, _u64, _P(_f32), _u32, _P(_u32)]),
    "ptps_set_entry": (_i32, [_vp, _u64, _u32, _P(_f32), _u32]),
    "ptps_set_entries": (_i32, [_vp, _P(_u64), _u64, _u32, _P(_f32), _u32]),
    "ptps_get_entries": (_i64, [_vp, _P(_u64), _u64, _u32, _P(_f32),
                                _P(_i64)]),
    "ptps_dump": (_i32, [_vp, ctypes.c_char_p]),
    "ptps_load": (_i32, [_vp, ctypes.c_char_p, _i32]),
    "ptps_row_dtype": (_i32, [_vp]),
    "ptps_resident_bytes": (_u64, [_vp]),
    "ptps_resident_emb_bytes": (_u64, [_vp]),
    "ptps_shard_resident_bytes": (None, [_vp, _P(_u64)]),
    "ptps_arena_stats": (None, [_vp, _P(_u64)]),
    "ptps_simd_path": (ctypes.c_char_p, []),
    "ptps_set_parallel": (None, [_vp, _u32, _u64]),
    "ptps_get_parallel": (None, [_vp, _P(_u64)]),
    "ptps_set_retain_evicted": (None, [_vp, _i32]),
    "ptps_evicted_bytes": (_u64, [_vp]),
    "ptps_drain_evicted": (_u64, [_vp, _P(_u8), _u64]),
    "ptps_contains": (None, [_vp, _P(_u64), _u64, _P(_u8)]),
}
# the eviction drain's record framing: sign u64 | dim u32 | nbytes u32
_DRAIN_REC = struct.Struct("<QII")

# the JAX package's capability sets, by the symbols that carry them (the
# port only reports them: its library always has both)
_ARENA_SYMBOLS = ("ptps_new2", "ptps_row_dtype", "ptps_resident_bytes",
                  "ptps_resident_emb_bytes", "ptps_shard_resident_bytes",
                  "ptps_arena_stats", "ptps_set_retain_evicted",
                  "ptps_evicted_bytes", "ptps_drain_evicted",
                  "ptps_contains")
_SIMD_SYMBOLS = ("ptps_simd_path", "ptps_set_parallel", "ptps_get_parallel",
                 "ptps_set_entries", "ptps_get_entries")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_flags() -> str:
    """The host's CPU feature line, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.strip()
    except OSError:
        pass
    return platform.processor()


def native_lib_path(src_dir: Optional[Path] = None) -> Path:
    """Where the library of the sources in ``src_dir`` (by default
    :data:`NATIVE_SRC_DIR`) is built on this host."""
    src_dir = src_dir or NATIVE_SRC_DIR
    digest = hashlib.sha256((src_dir / "capi.cc").read_bytes())
    for header in sorted(src_dir.glob("*.h")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    digest.update(platform.machine().encode())
    digest.update(_cpu_flags().encode())
    return BUILD_DIR / f"libpersia_native-{digest.hexdigest()[:16]}.so"


def native_jobs():
    """The ``g++`` job that builds the library, or none when it is built
    (for :func:`persia_tpu_torch.ops._build.build`'s ``extra_jobs``)."""
    path = native_lib_path()
    if path.exists():
        return []
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native PS store is "
                           "compiled at first use from native/src/")
    return [Job("libpersia_native", path, (cxx, *CXXFLAGS),
                NATIVE_SRC_DIR / "capi.cc")]


def load_native_lib() -> ctypes.CDLL:
    """The loaded native library, built from ``native/src/`` on first
    use. Raises when the build fails or a symbol is missing."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            compile_all(native_jobs())
            lib = ctypes.CDLL(str(native_lib_path()))
            bind_symbols(lib, _SIGNATURES)
            _lib = lib
    return _lib


def bind_symbols(lib: ctypes.CDLL, signatures: Dict[str, tuple]):
    """Set the types of ``signatures`` (symbol -> (restype, argtypes)) on
    ``lib``; raises naming every symbol the library lacks."""
    missing = [s for s in signatures if not hasattr(lib, s)]
    if missing:
        raise RuntimeError(f"the native library built from "
                           f"{NATIVE_SRC_DIR} lacks {missing}")
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def native_capabilities(lib=None) -> frozenset:
    """The storage-policy capabilities of the native library, named as
    the JAX package names them."""
    lib = lib if lib is not None else load_native_lib()
    caps = set()
    if all(hasattr(lib, s) for s in _ARENA_SYMBOLS):
        caps.update({"row_dtype", "capacity_bytes", "psd_v2", "spill",
                     "arena_stats"})
    if all(hasattr(lib, s) for s in _SIMD_SYMBOLS):
        caps.update({"simd", "parallel_tuning", "batched_entries"})
    return frozenset(caps)


def required_capabilities(row_dtype=None, capacity_bytes=None,
                          spill_dir=None) -> frozenset:
    """The capabilities a storage policy needs (empty: plain fp32 rows
    under a row budget)."""
    need = set()
    if row_dtype not in (None, "fp32"):
        need.update({"row_dtype", "psd_v2"})
    if capacity_bytes:
        need.add("capacity_bytes")
    if spill_dir:
        need.add("spill")
    return frozenset(need)


def native_simd_path(lib=None) -> str:
    """The kernel path the library selected: ``avx2``, ``neon`` or
    ``scalar`` (the C++ side reads ``PERSIA_NATIVE_SIMD``)."""
    lib = lib if lib is not None else load_native_lib()
    return lib.ptps_simd_path().decode()


def optimizer_config_to_wire(config: dict,
                             feature_index_prefix_bit: int = 0) -> str:
    """An optimizer config as the native wire string
    (``OptimizerConfig::parse`` in ``native/src/optim.h``)."""
    kind = config["type"]
    if kind == "sgd":
        return f"sgd {config['lr']} {config.get('wd', 0.0)}"
    if kind == "adagrad":
        return (
            f"adagrad {config.get('lr', 1e-2)} {config.get('wd', 0.0)} "
            f"{config.get('g_square_momentum', 1.0)} "
            f"{config.get('initialization', 1e-2)} {config.get('eps', 1e-10)} "
            f"{1 if config.get('vectorwise_shared', False) else 0}")
    if kind == "adam":
        return (
            f"adam {config.get('lr', 1e-3)} {config.get('beta1', 0.9)} "
            f"{config.get('beta2', 0.999)} {config.get('eps', 1e-8)} "
            f"{feature_index_prefix_bit}")
    raise ValueError(f"unknown optimizer type {kind!r}")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _params_array(params: dict):
    vals = [params.get("lower", -0.01), params.get("upper", 0.01),
            params.get("mean", 0.0), params.get("standard_deviation", 0.01),
            params.get("shape", 1.0), params.get("scale", 1.0),
            params.get("lambda", 1.0)]
    return (ctypes.c_double * 7)(*vals)


class NativeEmbeddingHolder:
    """The C++ arena store behind the Python holders' interface: fp32,
    fp16 or bf16 rows under a row budget and, with ``capacity_bytes``, a
    byte budget over the rows' logical bytes. ``spill_dir`` demotes
    evictions to the disk tier (at most ``spill_bytes`` on disk),
    ``hotness`` arms the workload sketches (None: the ``PERSIA_HOTNESS``
    knob).

    While spill-armed every call is serialized by the wrapper's lock: the
    drain -> resident filter -> spill handoff spans several foreign
    calls, and a training lookup landing between them would reinitialize
    a demoted row. The C++ store still runs its shards in parallel within
    a call; an unarmed holder takes no lock."""

    # ctypes releases the interpreter lock for the duration of every
    # foreign call
    releases_gil = True

    def __init__(self, capacity: int = 1_000_000_000,
                 num_internal_shards: int = 8,
                 hotness: Optional[bool] = None, row_dtype: str = "fp32",
                 capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_bytes: Optional[int] = None):
        if num_internal_shards <= 0:
            raise ValueError("num_internal_shards must be positive")
        row_dtype = row_dtype or "fp32"
        self._rp = RowPrecision(row_dtype)
        lib = load_native_lib()
        self._lib = lib
        self._h = lib.ptps_new2(capacity, num_internal_shards,
                                _ROW_DTYPE_CODES[row_dtype],
                                capacity_bytes or 0)
        if not self._h:
            raise RuntimeError("ptps_new2 refused the storage policy")
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes or None
        self.num_internal_shards = num_internal_shards
        self.row_dtype = row_dtype
        self.simd_path = native_simd_path(lib)
        # the registered config; None until register_optimizer, as the
        # Python holders' optimizer
        self.optimizer: Optional[dict] = None
        # the tracker owns its own leaf locks: observing before the
        # foreign call races nothing
        self.hotness = make_tracker(num_internal_shards, enabled=hotness)
        self.spill: Optional[SpillStore] = None
        self._mu: Optional[threading.RLock] = None
        if spill_dir:
            self.spill = SpillStore(spill_dir, max_bytes=spill_bytes or None)
            lib.ptps_set_retain_evicted(self._h, 1)
            self._mu = threading.RLock()

    def _guard(self):
        return self._mu if self._mu is not None else (
            contextlib.nullcontext())

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ptps_free(h)
            self._h = None

    def parallel_info(self) -> Dict[str, int]:
        """The store's shard-parallel worker count for one call, and the
        batch size below which a call stays on its calling thread."""
        out = np.zeros(2, np.uint64)
        self._lib.ptps_get_parallel(self._h, _ptr(out, ctypes.c_uint64))
        return {"threads": int(out[0]), "min_batch": int(out[1])}

    def set_parallel(self, threads: int = 0, min_batch: int = 0) -> bool:
        """Tune the shard-parallel engine: ``threads=0`` restores the
        default (the cores, at most 8), ``min_batch=0`` keeps the serial
        threshold."""
        self._lib.ptps_set_parallel(self._h, int(threads), int(min_batch))
        return True

    def configure(self, init_method: str, init_params: dict,
                  admit_probability: float = 1.0, weight_bound: float = 10.0,
                  enable_weight_bound: bool = True):
        self._lib.ptps_configure(
            self._h, _INIT_METHOD_CODES[init_method],
            _params_array(init_params), admit_probability, weight_bound,
            1 if enable_weight_bound else 0)

    def register_optimizer(self, config: dict,
                           feature_index_prefix_bit: int = 0):
        wire = optimizer_config_to_wire(config, feature_index_prefix_bit)
        if self._lib.ptps_register_optimizer(self._h, wire.encode()) != 0:
            raise ValueError(f"native optimizer rejected config {config}")
        self.optimizer = dict(config)

    # --- spill plumbing ---------------------------------------------------

    def _drain_evictions(self):
        """Demote the store's retained evictions to the disk tier, in
        their logical bytes, grouped per (dim, nbytes) for the batched
        spill path. A sign evicted and re-admitted within the same call
        is resident again and is left out."""
        lib = self._lib
        while True:
            need = int(lib.ptps_evicted_bytes(self._h))
            if not need:
                return
            buf = np.empty(need, np.uint8)
            got = int(lib.ptps_drain_evicted(self._h, _ptr(buf, _u8), need))
            if not got:
                return
            groups: Dict[Tuple[int, int], Tuple[list, list]] = {}
            off = 0
            while off + _DRAIN_REC.size <= got:
                sign, dim, nbytes = _DRAIN_REC.unpack_from(buf, off)
                off += _DRAIN_REC.size
                g = groups.setdefault((dim, nbytes), ([], []))
                g[0].append(sign)
                g[1].append(off)
                off += nbytes
            for (dim, nbytes), (signs, offs) in groups.items():
                signs = np.array(signs, np.uint64)
                starts = np.asarray(offs, np.int64)
                mat = buf[starts[:, None]
                          + np.arange(nbytes, dtype=np.int64)[None, :]]
                resident = np.zeros(len(signs), np.uint8)
                lib.ptps_contains(self._h, _ptr(signs, ctypes.c_uint64),
                                  len(signs), _ptr(resident, _u8))
                keep = resident == 0
                if keep.any():
                    self.spill.put_batch(signs[keep], dim, mat[keep])

    def _fault_in(self, signs: np.ndarray, training: bool) -> np.ndarray:
        """Promote the batch's spilled signs back into the store
        (training) or only report them (read paths). Returns the
        spilled-sign mask. Rows these promotions evict stay in the
        store's drain buffer, where the following data call's misses find
        them; the caller drains after that call."""
        mask = self.spill.contains_batch(signs)
        if training and mask.any():
            for s in signs[mask].tolist():
                got = self.spill.take(s)
                if got is None:
                    continue
                dim0, raw = got
                vec = self._rp.unpack_raw(raw, dim0)
                self._lib.ptps_set_entry(self._h, s, dim0,
                                         _ptr(vec, ctypes.c_float), len(vec))
        return mask

    # --- data plane -------------------------------------------------------

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        with self._guard():
            return self._lookup_locked(signs, dim, training)

    def _lookup_locked(self, signs: np.ndarray, dim: int,
                       training: bool) -> np.ndarray:
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.empty((len(signs), dim), dtype=np.float32)
        if len(signs) == 0:
            return out
        if self.hotness is not None:
            self.hotness.observe(dim, signs)
        spilled = None
        if self.spill is not None and len(self.spill):
            spilled = self._fault_in(signs, training)
        if not training and spilled is not None and spilled.any():
            # a read-only lookup peeks the disk tier (residency must not
            # change); the store sees only the resident signs
            sub = np.ascontiguousarray(signs[~spilled])
            sub_out = np.empty((len(sub), dim), np.float32)
            if len(sub):
                rc = self._lib.ptps_lookup(
                    self._h, _ptr(sub, ctypes.c_uint64), len(sub), dim, 0,
                    _ptr(sub_out, ctypes.c_float))
                if rc != 0:
                    raise RuntimeError("native lookup failed")
            out[~spilled] = sub_out
            for j in np.nonzero(spilled)[0]:
                got = self.spill.peek(int(signs[j]))
                if got is not None and got[0] == dim:
                    out[j] = self._rp.unpack_raw(got[1], dim)[:dim]
                else:
                    out[j] = 0.0
            return out
        rc = self._lib.ptps_lookup(self._h, _ptr(signs, ctypes.c_uint64),
                                   len(signs), dim, 1 if training else 0,
                                   _ptr(out, ctypes.c_float))
        if rc != 0:
            raise RuntimeError("native lookup failed (optimizer not "
                               "registered or store not configured)")
        if training and self.spill is not None:
            self._drain_evictions()
        return out

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray,
                         dim: int):
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        if grads.shape != (len(signs), dim):
            raise ValueError(f"grads of shape {grads.shape} for "
                             f"{len(signs)} signs of dim {dim}")
        if len(signs) == 0:
            return
        with self._guard():
            if self.spill is not None and len(self.spill):
                # a gradient for a spilled row faults it in first
                self._fault_in(signs, True)
            rc = self._lib.ptps_update(self._h, _ptr(signs, ctypes.c_uint64),
                                       len(signs), dim,
                                       _ptr(grads, ctypes.c_float))
            if rc != 0:
                raise RuntimeError("native update failed (optimizer not "
                                   "registered)")
            if self.spill is not None:
                self._drain_evictions()

    def get_entry(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        """(dim, f32 [emb|state]) or None; a spilled row reads through
        (peek)."""
        with self._guard():
            dim_out = ctypes.c_uint32(0)
            length = self._lib.ptps_get_entry(self._h, sign, None, 0,
                                              ctypes.byref(dim_out))
            if length < 0:
                if self.spill is not None:
                    got = self.spill.peek(int(sign))
                    if got is not None:
                        return got[0], self._rp.unpack_raw(got[1], got[0])
                return None
            buf = np.empty(length, dtype=np.float32)
            self._lib.ptps_get_entry(self._h, sign,
                                     _ptr(buf, ctypes.c_float), length,
                                     ctypes.byref(dim_out))
            return int(dim_out.value), buf

    def set_entry(self, sign: int, dim: int, vec: np.ndarray):
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        if vec.ndim != 1 or len(vec) < dim:
            raise ValueError(f"vec of shape {vec.shape} for dim {dim}")
        with self._guard():
            if self.spill is not None:
                self.spill.discard(int(sign))
            self._lib.ptps_set_entry(self._h, sign, dim,
                                     _ptr(vec, ctypes.c_float), len(vec))
            if self.spill is not None:
                self._drain_evictions()

    def get_entries(self, signs: np.ndarray, width: int):
        """Rows of width ``width`` (embedding and optimizer state) by
        sign: (found, vecs); an absent row, or one of another width, is
        not found and reads zeros. Spilled rows read through (peek)."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        vecs = np.zeros((n, width), dtype=np.float32)
        if n == 0:
            return np.zeros(0, dtype=bool), vecs
        lens = np.empty(n, dtype=np.int64)
        with self._guard():
            self._lib.ptps_get_entries(
                self._h, _ptr(signs, ctypes.c_uint64), n, width,
                _ptr(vecs, ctypes.c_float), _ptr(lens, ctypes.c_int64))
            found = lens == width
            # the call wrote the prefix of a row of another width
            vecs[(lens >= 0) & ~found] = 0.0
            if self.spill is not None and len(self.spill):
                for i in np.nonzero(lens < 0)[0]:
                    got = self.spill.peek(int(signs[i]))
                    if got is None:
                        continue
                    vec = self._rp.unpack_raw(got[1], got[0])
                    if len(vec) == width:
                        found[i] = True
                        vecs[i] = vec
        return found, vecs

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or len(vecs) != len(signs) or vecs.shape[1] < dim:
            raise ValueError(f"vecs of shape {vecs.shape} for {len(signs)} "
                             f"signs of dim {dim}")
        if len(signs) == 0:
            return
        with self._guard():
            if self.spill is not None:
                for s in signs.tolist():
                    self.spill.discard(s)
            rc = self._lib.ptps_set_entries(
                self._h, _ptr(signs, ctypes.c_uint64), len(signs), dim,
                _ptr(vecs, ctypes.c_float), vecs.shape[1])
            if rc != 0:
                raise RuntimeError("native set_entries failed (len < dim)")
            if self.spill is not None:
                self._drain_evictions()

    def clear(self):
        with self._guard():
            self._lib.ptps_clear(self._h)
            if self.spill is not None:
                self.spill.clear()

    def __len__(self) -> int:
        """Rows of the logical table: resident plus spilled."""
        with self._guard():
            n = int(self._lib.ptps_len(self._h))
            if self.spill is not None:
                n += len(self.spill)
            return n

    # --- observables ------------------------------------------------------

    @property
    def index_miss_count(self) -> int:
        return int(self._lib.ptps_index_miss_count(self._h))

    @property
    def gradient_id_miss_count(self) -> int:
        return int(self._lib.ptps_gradient_id_miss_count(self._h))

    @property
    def resident_bytes(self) -> int:
        return int(self._lib.ptps_resident_bytes(self._h))

    @property
    def resident_emb_bytes(self) -> int:
        return int(self._lib.ptps_resident_emb_bytes(self._h))

    def resident_bytes_per_shard(self):
        out = np.zeros(self.num_internal_shards, np.uint64)
        self._lib.ptps_shard_resident_bytes(self._h,
                                            _ptr(out, ctypes.c_uint64))
        return [int(b) for b in out]

    def arena_stats(self) -> Dict[str, float]:
        """Slab bytes, reusable free slots, live rows, logical resident
        bytes and the fragmentation ratio (free / allocated slots)."""
        out = np.zeros(4, np.uint64)
        self._lib.ptps_arena_stats(self._h, _ptr(out, ctypes.c_uint64))
        slab, free_slots, live, logical = (int(x) for x in out)
        alloc = free_slots + live
        return {"slab_bytes": slab, "free_slots": free_slots,
                "live_rows": live, "resident_bytes": logical,
                "fragmentation_ratio": (round(free_slots / alloc, 6)
                                        if alloc else 0.0)}

    def row_nbytes(self, dim: int) -> int:
        """Logical bytes of one row of ``dim`` under the registered
        optimizer."""
        space = 0
        if self.optimizer is not None:
            space = SparseOptimizer.from_config(
                dict(self.optimizer)).require_space(dim)
        return self._rp.entry_nbytes(dim, space)

    def spill_stats(self) -> dict:
        """The disk tier's counters (empty when unarmed)."""
        return self.spill.stats() if self.spill is not None else {}

    def hotness_snapshot(self) -> dict:
        """The hotness sketches' snapshot, each table stamped with its
        stored bytes a row; the disabled marker when unarmed."""
        if self.hotness is None:
            return disabled_snapshot()
        snap = self.hotness.snapshot()
        for table, t in snap.get("tables", {}).items():
            t["row_bytes"] = int(table) * self._rp.itemsize
        return snap

    # --- serialization ----------------------------------------------------

    def dump_file(self, path: str):
        """PSD v1 (fp32 rows) or v2, byte-identical to the Python
        holders' dumps. A spill-armed store dumps the logical table: the
        store's resident rows, behind them the spilled rows, and in front
        the rows that left the spill tier while the dump ran (lowest load
        priority: any newer record of the same sign wins)."""
        path = str(path)
        with self._guard():
            if self.spill is None:
                if self._lib.ptps_dump(self._h, path.encode()) != 0:
                    raise IOError(f"native dump to {path} failed")
                return
            self._dump_spilled(path)

    def _dump_spilled(self, path: str):
        rp = self._rp
        code = _ROW_DTYPE_CODES[self.row_dtype]

        def rec(version, sign, dim, raw):
            state_len = (len(raw) - dim * rp.itemsize) // 4
            if version == 1:
                head = struct.pack("<QII", sign, dim, dim + state_len)
            else:
                head = struct.pack("<QIBI", sign, dim, code, state_len)
            return head + raw.tobytes()

        tmp, spill_tmp = path + ".native_part", path + ".spill_part"
        self.spill.start_dump_capture()
        try:
            if self._lib.ptps_dump(self._h, tmp.encode()) != 0:
                raise IOError(f"native dump to {tmp} failed")
            head_len = 4 + struct.calcsize("<IQ")
            with open(tmp, "rb") as src, open(path, "wb") as dst:
                head = src.read(head_len)
                version, count = struct.unpack_from("<IQ", head, 4)
                dst.write(head)
                # the spilled records go to a side file first, with the
                # capture armed; the captured ones are written in front,
                # then the store's body, then the side file; the count is
                # patched into the header last
                with open(spill_tmp, "wb") as sp:
                    for sign, dim, raw in self.spill.items():
                        sp.write(rec(version, sign, dim, raw))
                        count += 1
                for sign, (dim, raw) in \
                        self.spill.stop_dump_capture().items():
                    dst.write(rec(version, sign, dim, raw))
                    count += 1
                shutil.copyfileobj(src, dst, 4 << 20)
                with open(spill_tmp, "rb") as sp:
                    shutil.copyfileobj(sp, dst, 4 << 20)
                dst.seek(8)
                dst.write(struct.pack("<Q", count))
        finally:
            self.spill.stop_dump_capture()
            for t in (tmp, spill_tmp):
                if os.path.exists(t):
                    os.remove(t)

    def load_file(self, path: str, clear: bool = True):
        """Load a PSD v1 or v2 file, of any row precision. With the spill
        tier armed, rows the load evicts are demoted to it; a merge load
        (``clear=False``) goes record by record so each loaded sign drops
        its stale spilled copy."""
        path = str(path)
        with self._guard():
            if self.spill is not None:
                if not clear:
                    with open(path, "rb") as f:
                        version, count = read_psd_header(f, path)
                        for sign, dim, vec in iter_psd_records(
                                f.read, version, count):
                            self.set_entry(sign, dim, vec)
                    return
                self.spill.clear()
            if self._lib.ptps_load(self._h, path.encode(),
                                   1 if clear else 0) != 0:
                raise IOError(f"native load from {path} failed")
            if self.spill is not None:
                self._drain_evictions()


BACKENDS = ("auto", "native", "arena", "python-legacy")


def make_holder(capacity: int, num_internal_shards: int,
                prefer_native: bool = True, row_dtype: str = "fp32",
                capacity_bytes=None, hotness=None, spill_dir=None,
                spill_bytes=None, backend: Optional[str] = None):
    """The holder for a storage policy:

    - ``auto`` (the default; ``backend=None`` reads ``PERSIA_PS_BACKEND``)
      and ``native``:
      the native C++ store, :class:`NativeEmbeddingHolder`, built at
      first use; ``prefer_native=False`` maps ``auto`` to ``arena``;
    - ``arena``: the Python arena holder (:mod:`persia_tpu_torch.ps.arena`);
    - ``python-legacy``: the per-entry ``EmbeddingHolder`` (the A/B
      baseline), under the same ``row_dtype`` and ``capacity_bytes``.

    ``spill_dir`` (at most ``spill_bytes`` on disk) and ``hotness`` arm
    the disk spill tier and the hotness sketches on every backend.
    """
    backend = backend or knobs.get("PERSIA_PS_BACKEND") or "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown PS backend {backend!r} (expected "
                         f"{'|'.join(BACKENDS)})")
    if backend == "auto":
        backend = "native" if prefer_native else "arena"
    if backend == "python-legacy":
        return EmbeddingHolder(capacity, num_internal_shards,
                               row_dtype=row_dtype or "fp32",
                               capacity_bytes=capacity_bytes,
                               hotness=hotness, spill_dir=spill_dir,
                               spill_bytes=spill_bytes)
    cls = NativeEmbeddingHolder if backend == "native" else \
        ArenaEmbeddingHolder
    return cls(capacity, num_internal_shards, row_dtype=row_dtype or "fp32",
               capacity_bytes=capacity_bytes, hotness=hotness,
               spill_dir=spill_dir, spill_bytes=spill_bytes)
