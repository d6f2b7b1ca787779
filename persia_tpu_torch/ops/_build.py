"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the
package (git-ignored); the hash of the source names the library, so an
edited source is rebuilt and an unchanged one is reused. Nothing here
runs at import time: the CPU tests import every module of the port on a
machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each kernel printed (the ptxas register, shared
# memory and spill report), for the chip smoke run
build_logs: Dict[str, str] = {}
# launches of each kernel since its last reset, counted by launch() when
# the launcher succeeds; the plain versions on the CPU never count
_launches: Dict[str, int] = {}
_count_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are compiled at first use on a machine with the CUDA "
        "toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> List[Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the library paths."""
    paths = [_lib_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
        # build to a private name, then rename: a concurrent build never
        # loads a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib


def count_launch(kernel: str):
    with _count_lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_count(kernel: str) -> int:
    return _launches.get(kernel, 0)


def reset_launch_counts(kernels: Iterable[str]):
    with _count_lock:
        for kernel in kernels:
            _launches[kernel] = 0


def launch(kernel: str, source: str, symbol: str, argtypes, device, *args):
    """Launch ``kernel``: call the C launcher ``symbol`` of
    ``csrc/<source>.cu`` with ``args`` and torch's current stream on
    ``device``, raise on a non-zero ``cudaError_t`` (every launcher
    returns one and every source defines ``persia_cuda_error_string``),
    and count the launch."""
    import torch

    lib = load(source)
    fn = getattr(lib, symbol)  # ctypes caches the function object
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        err = lib.persia_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    count_launch(kernel)
