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
"""

import ctypes
import hashlib
import platform
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from persia_tpu_torch.ops._build import BUILD_DIR, Job, compile_all
from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder
from persia_tpu_torch.ps.optim import RowPrecision, SparseOptimizer
from persia_tpu_torch.ps.store import EmbeddingHolder

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
}

# the JAX package's capability sets, by the symbols that carry them (the
# port only reports them: its library always has both)
_ARENA_SYMBOLS = ("ptps_new2", "ptps_row_dtype", "ptps_resident_bytes",
                  "ptps_resident_emb_bytes", "ptps_shard_resident_bytes",
                  "ptps_arena_stats")
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
        caps.update({"row_dtype", "capacity_bytes", "psd_v2",
                     "arena_stats"})
    if all(hasattr(lib, s) for s in _SIMD_SYMBOLS):
        caps.update({"simd", "parallel_tuning", "batched_entries"})
    return frozenset(caps)


def required_capabilities(row_dtype=None, capacity_bytes=None) -> frozenset:
    """The capabilities a storage policy needs (empty: plain fp32 rows
    under a row budget)."""
    need = set()
    if row_dtype not in (None, "fp32"):
        need.update({"row_dtype", "psd_v2"})
    if capacity_bytes:
        need.add("capacity_bytes")
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
    byte budget over the rows' logical bytes. The disk spill tier and the
    hotness sketches are not ported (ROADMAP.md queue A item 2c)."""

    # ctypes releases the interpreter lock for the duration of every
    # foreign call
    releases_gil = True

    def __init__(self, capacity: int = 1_000_000_000,
                 num_internal_shards: int = 8,
                 hotness: Optional[bool] = None, row_dtype: str = "fp32",
                 capacity_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_bytes: Optional[int] = None):
        if spill_dir:
            raise NotImplementedError(
                "NativeEmbeddingHolder(spill_dir=...): the disk spill tier "
                "(persia_tpu/ps/spill.py) is not ported yet; it waits for "
                "ROADMAP.md queue A item 2c")
        if hotness:
            raise NotImplementedError(
                "NativeEmbeddingHolder(hotness=True): the hotness sketches "
                "(persia_tpu/hotness.py) are not ported yet; they wait for "
                "ROADMAP.md queue A item 2c")
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

    # --- data plane -------------------------------------------------------

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.empty((len(signs), dim), dtype=np.float32)
        if len(signs) == 0:
            return out
        rc = self._lib.ptps_lookup(self._h, _ptr(signs, ctypes.c_uint64),
                                   len(signs), dim, 1 if training else 0,
                                   _ptr(out, ctypes.c_float))
        if rc != 0:
            raise RuntimeError("native lookup failed (optimizer not "
                               "registered or store not configured)")
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
        rc = self._lib.ptps_update(self._h, _ptr(signs, ctypes.c_uint64),
                                   len(signs), dim,
                                   _ptr(grads, ctypes.c_float))
        if rc != 0:
            raise RuntimeError("native update failed (optimizer not "
                               "registered)")

    def get_entry(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        dim_out = ctypes.c_uint32(0)
        length = self._lib.ptps_get_entry(self._h, sign, None, 0,
                                          ctypes.byref(dim_out))
        if length < 0:
            return None
        buf = np.empty(length, dtype=np.float32)
        self._lib.ptps_get_entry(self._h, sign, _ptr(buf, ctypes.c_float),
                                 length, ctypes.byref(dim_out))
        return int(dim_out.value), buf

    def set_entry(self, sign: int, dim: int, vec: np.ndarray):
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        if vec.ndim != 1 or len(vec) < dim:
            raise ValueError(f"vec of shape {vec.shape} for dim {dim}")
        self._lib.ptps_set_entry(self._h, sign, dim,
                                 _ptr(vec, ctypes.c_float), len(vec))

    def get_entries(self, signs: np.ndarray, width: int):
        """Rows of width ``width`` (embedding and optimizer state) by
        sign: (found, vecs); an absent row, or one of another width, is
        not found and reads zeros."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        vecs = np.zeros((n, width), dtype=np.float32)
        if n == 0:
            return np.zeros(0, dtype=bool), vecs
        lens = np.empty(n, dtype=np.int64)
        self._lib.ptps_get_entries(self._h, _ptr(signs, ctypes.c_uint64), n,
                                   width, _ptr(vecs, ctypes.c_float),
                                   _ptr(lens, ctypes.c_int64))
        found = lens == width
        # the call wrote the prefix of a row of another width
        vecs[(lens >= 0) & ~found] = 0.0
        return found, vecs

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or len(vecs) != len(signs) or vecs.shape[1] < dim:
            raise ValueError(f"vecs of shape {vecs.shape} for {len(signs)} "
                             f"signs of dim {dim}")
        if len(signs) == 0:
            return
        rc = self._lib.ptps_set_entries(
            self._h, _ptr(signs, ctypes.c_uint64), len(signs), dim,
            _ptr(vecs, ctypes.c_float), vecs.shape[1])
        if rc != 0:
            raise RuntimeError("native set_entries failed (len < dim)")

    def clear(self):
        self._lib.ptps_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.ptps_len(self._h))

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

    # --- serialization ----------------------------------------------------

    def dump_file(self, path: str):
        """PSD v1 (fp32 rows) or v2, byte-identical to the Python
        holders' dumps."""
        if self._lib.ptps_dump(self._h, str(path).encode()) != 0:
            raise IOError(f"native dump to {path} failed")

    def load_file(self, path: str, clear: bool = True):
        """Load a PSD v1 or v2 file, of any row precision."""
        if self._lib.ptps_load(self._h, str(path).encode(),
                               1 if clear else 0) != 0:
            raise IOError(f"native load from {path} failed")


BACKENDS = ("auto", "native", "arena", "python-legacy")


def make_holder(capacity: int, num_internal_shards: int,
                prefer_native: bool = True, row_dtype: str = "fp32",
                capacity_bytes=None, hotness=None, spill_dir=None,
                spill_bytes=None, backend: Optional[str] = None):
    """The holder for a storage policy:

    - ``auto`` (the default, also for ``backend=None``) and ``native``:
      the native C++ store, :class:`NativeEmbeddingHolder`, built at
      first use; ``prefer_native=False`` maps ``auto`` to ``arena``;
    - ``arena``: the Python arena holder (:mod:`persia_tpu_torch.ps.arena`);
    - ``python-legacy``: the per-entry ``EmbeddingHolder``, fp32 rows with
      a row budget only (the A/B baseline).
    """
    backend = backend or "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown PS backend {backend!r} (expected "
                         f"{'|'.join(BACKENDS)})")
    if backend == "auto":
        backend = "native" if prefer_native else "arena"
    if backend == "python-legacy":
        if ((row_dtype or "fp32") != "fp32" or capacity_bytes or hotness
                or spill_dir):
            raise NotImplementedError(
                "make_holder(backend='python-legacy') keeps fp32 rows under "
                "a row budget only; use backend='arena' for row_dtype, "
                "capacity_bytes, hotness or spill_dir")
        return EmbeddingHolder(capacity, num_internal_shards)
    cls = NativeEmbeddingHolder if backend == "native" else \
        ArenaEmbeddingHolder
    return cls(capacity, num_internal_shards, row_dtype=row_dtype or "fp32",
               capacity_bytes=capacity_bytes, hotness=hotness,
               spill_dir=spill_dir, spill_bytes=spill_bytes)
