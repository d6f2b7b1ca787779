"""The native service binaries, built by the port from the checkout
(what ``persia_tpu/utils.py`` ``resolve_binary_path`` finds prebuilt).

``persia-embedding-ps`` (``native/src/ps_server.cc``) and
``persia-embedding-worker`` (``native/src/worker_server.cc``) are the C++
PS and worker of the JAX package: the PS over the store of
``native/src/store.h``, the worker over the middleware kernels of
``native/src/mw_kernels.h``. ``ServiceCtx(native_ps=True,
native_worker=True)`` runs them in place of the Python services.

:func:`ensure_binaries` compiles them at first use with ``g++`` and the
flags of ``native/Makefile`` (:data:`CXXFLAGS`, then ``-lzstd``), all
together, into ``persia_tpu_torch/_build/<name>-<zstd mode>-<hash>``,
never ``native/build/``. The hash covers the binary's source, every
``native/src/*.h``, the flags, and the host's machine and CPU flags
(``-march=native``). The compiler writes a private name that is renamed
into place, under a file lock, so that test processes building at once
compile once and never run a half-written binary.

The wire: both binaries speak the RPC framing of
:mod:`persia_tpu_torch.rpc`, and compress a reply with zstd only when the
peer is not on loopback (``ps_server.cc``, ``worker_server.cc``
``fd_is_loopback``). The port's client refuses a zstd frame where the
``zstandard`` module is missing (``ROADMAP.md`` §C), so a trainer or a
server reaches binaries on another host only where it has that module.
A host without zstd's headers and library (:func:`zstd_mode` finds out by
compiling a probe) gets binaries built against the port's own
``csrc/zstd_shim/zstd.h``: they never compress, and refuse a compressed
frame by closing the connection.

The C++ worker answers ``forward_batched``, ``forward_batch_id``,
``forward_batched_direct``, ``update_gradients``, ``configure``,
``register_optimizer``, ``dump``, ``load``, ``staleness`` and ``ready``:
everything a training step or an uncached serving lookup calls. Any
other call of :class:`~persia_tpu_torch.service.worker_service.\
RemoteEmbeddingWorker` (``lookup_signs``, the serving cache's miss fetch;
``apply_routing``, ``close_routing_window``) raises the RPC's
``no such method`` error, as it does against the JAX package's.
"""

import fcntl
import functools
import hashlib
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from persia_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR, Job, \
    compile_all
from persia_tpu_torch.ps.native import NATIVE_SRC_DIR, _cpu_flags

# name -> source under native/src/
BINARIES = {"persia-embedding-ps": "ps_server.cc",
            "persia-embedding-worker": "worker_server.cc"}
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
            "-fPIC", "-Wall", "-Wextra", "-pthread")
ZSTD_SHIM_DIR = CSRC_DIR / "zstd_shim"
# zstd mode -> (extra compiler flags, libraries)
_ZSTD = {"system": ((), ("-lzstd",)),
         "shim": (("-I", str(ZSTD_SHIM_DIR)), ())}
_PROBE = ("#include <zstd.h>\n"
          "int main() { return ZSTD_versionNumber() == 0; }\n")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native service "
                           "binaries are compiled at first use from "
                           "native/src/")
    return cxx


@functools.lru_cache(maxsize=None)
def zstd_mode() -> str:
    """``system`` when ``g++`` compiles and links a zstd probe on this
    host (the Makefile's ``-lzstd``), else ``shim``."""
    probe = subprocess.run(
        [_cxx(), "-x", "c++", "-", "-lzstd", "-o", "/dev/null"],
        input=_PROBE, capture_output=True, text=True)
    return "system" if probe.returncode == 0 else "shim"


def _flags(zstd: str):
    extra, libs = _ZSTD[zstd]
    return (*CXXFLAGS, *extra), libs


def binary_path(name: str, zstd: Optional[str] = None) -> Path:
    """Where binary ``name`` of the current sources is built on this host
    (against ``zstd``'s headers, by default :func:`zstd_mode`'s)."""
    zstd = zstd or zstd_mode()
    flags, libs = _flags(zstd)
    digest = hashlib.sha256((NATIVE_SRC_DIR / BINARIES[name]).read_bytes())
    for header in sorted(NATIVE_SRC_DIR.glob("*.h")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    if zstd == "shim":
        digest.update((ZSTD_SHIM_DIR / "zstd.h").read_bytes())
    digest.update(" ".join((*flags, *libs)).encode())
    digest.update(platform.machine().encode())
    digest.update(_cpu_flags().encode())
    return BUILD_DIR / f"{name}-{zstd}-{digest.hexdigest()[:16]}"


def binary_jobs(names: Sequence[str] = tuple(BINARIES),
                zstd: Optional[str] = None) -> List[Job]:
    """The ``g++`` jobs of the named binaries not built yet (for
    :func:`persia_tpu_torch.ops._build.build`'s ``extra_jobs``)."""
    zstd = zstd or zstd_mode()
    todo = [(n, binary_path(n, zstd)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return []
    flags, libs = _flags(zstd)
    cxx = _cxx()
    return [Job(n, p, (cxx, *flags), NATIVE_SRC_DIR / BINARIES[n], libs)
            for n, p in todo]


def ensure_binaries(names: Sequence[str] = tuple(BINARIES),
                    zstd: Optional[str] = None) -> Dict[str, str]:
    """name -> path of each named binary, building the missing ones
    together under a file lock first. Raises with the compiler's output
    when a build fails."""
    unknown = sorted(set(names) - set(BINARIES))
    if unknown:
        raise FileNotFoundError(f"no native binary {unknown}; the port "
                                f"builds {sorted(BINARIES)}")
    zstd = zstd or zstd_mode()
    paths = {n: binary_path(n, zstd) for n in names}
    if not all(p.exists() for p in paths.values()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "native-binaries.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            # none when another process built them while this one waited
            compile_all(binary_jobs(names, zstd))
    return {n: str(p) for n, p in paths.items()}
