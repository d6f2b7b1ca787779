"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` inside the
package (git-ignored); the hash of the source and of the shared headers
``csrc/*.cuh`` names the library, so an edited source or header is
rebuilt and an unchanged one is reused. Nothing here
runs at import time: the CPU tests import every module of the port on a
machine without ``nvcc``. :func:`compile_all` (private output name, then
a rename) also builds the native PS library of
:mod:`persia_tpu_torch.ps.native` with ``g++``.

A kernel is launched through its :class:`Launcher`, resolved once per C
entry by :func:`launcher`: the hot path is one Python call and one ctypes
call, with the stream read as a raw pointer and no device guard unless
the caller's current device differs.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Sequence

import torch

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
# launches of each kernel since its last reset, counted by a Launcher when
# the launch succeeds; the plain versions on the CPU never count
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
    # every shared header, since a source may include any of them
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


class Job(NamedTuple):
    """One compiler run: ``cmd -o <private name> source``, renamed to
    ``path`` once it succeeded."""

    name: str
    path: Path
    cmd: Sequence[str]
    source: Path


def compile_all(jobs: Sequence[Job]) -> Dict[str, str]:
    """Run every job's compiler, all started together. Each writes to a
    private name and is renamed into place, so a concurrent build (another
    process, another test file) never loads a half-written library.
    Returns each job's compiler output; raises with the output of every
    job that failed."""
    if not jobs:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for job in jobs:
        tmp = job.path.with_suffix(f".{os.getpid()}.tmp")
        procs.append((job, tmp, subprocess.Popen(
            [*job.cmd, "-o", str(tmp), str(job.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for job, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[job.name] = log
        if proc.returncode != 0:
            failed.append(f"{job.name}: {job.cmd[0]} exited "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, job.path)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return logs


def kernel_jobs(names: Sequence[str]) -> List[Job]:
    """The nvcc jobs of the named kernels that are not built yet."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return []
    cmd = (_nvcc(), *NVCC_FLAGS)
    return [Job(n, p, cmd, CSRC_DIR / f"{n}.cu") for n, p in todo]


def build(names: Sequence[str], extra_jobs: Sequence[Job] = ()
          ) -> List[Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, together with ``extra_jobs``, all started at once. Returns
    the kernels' library paths."""
    jobs = kernel_jobs(names)
    logs = compile_all([*jobs, *extra_jobs])
    build_logs.update({j.name: logs[j.name] for j in jobs})
    return [_lib_path(n) for n in names]


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


# The current device and the raw pointer of torch's current stream on a
# device, read without building a ``torch.cuda.Stream``; module functions
# so that a test without a card can stand in for them.
def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def _device_guard(index: int):
    return torch.cuda.device(index)


class Launcher:
    """One C launcher ``symbol`` of ``csrc/<source>.cu`` resolved once: its
    ctypes function has its ``argtypes`` (``argtypes`` then the stream)
    and ``restype`` set here, so a launch is one Python call and one
    ctypes call. ``launcher(device, *args)`` passes ``args`` and torch's
    current stream on ``device``, raises on a non-zero ``cudaError_t``
    (every launcher returns one and every source defines
    ``persia_cuda_error_string``), and counts ``kernel``'s launch only
    when it succeeded. A device guard is entered only when the calling
    thread's current device is another one."""

    __slots__ = ("kernel", "fn", "error_string")

    def __init__(self, kernel: str, lib, symbol: str, argtypes):
        self.kernel = kernel
        self.fn = getattr(lib, symbol)
        self.fn.argtypes = [*argtypes, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.error_string = lib.persia_cuda_error_string
        self.error_string.argtypes = [ctypes.c_int]
        self.error_string.restype = ctypes.c_char_p

    def __call__(self, device, *args):
        index = device.index
        current = _current_device()
        if index is None or index == current:
            rc = self.fn(*args, _raw_stream(current))
        else:
            with _device_guard(index):
                rc = self.fn(*args, _raw_stream(index))
        if rc:
            raise RuntimeError(
                f"{self.kernel} kernel launch failed: CUDA error {rc} "
                f"({self.error_string(rc).decode()})")
        count_launch(self.kernel)


_launchers: Dict[tuple, Launcher] = {}


def launcher(kernel: str, source: str, symbol: str, argtypes) -> Launcher:
    """The :class:`Launcher` of ``symbol`` in ``csrc/<source>.cu``,
    building and loading the library at first use."""
    key = (source, symbol)
    fn = _launchers.get(key)
    if fn is None:
        lib = load(source)
        with _lock:
            fn = _launchers.get(key)
            if fn is None:
                fn = Launcher(kernel, lib, symbol, argtypes)
                _launchers[key] = fn
    return fn
